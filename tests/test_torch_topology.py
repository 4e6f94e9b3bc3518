"""The port's topology layer (isac_tpu_torch/topology/) against isac_tpu's.

Both are host numpy with the same float64 expressions in the same order, so
every result is compared exactly (assert_array_equal, no tolerance): the
blockage counts, LoS flags and penetration losses of ~1000 segments in the
shipped synthetic city (segments ending on wall corners and running along
walls included), the synthetic city itself, the city JSON written by either
package and read by the other, and the wraparound layout. The 13 cases of
tests/test_topology.py run again against the port.
"""

import json

import numpy as np
import pytest

import isac_tpu.config.params as j_params
import isac_tpu.topology as j_topo
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.topology as t_topo
from isac_tpu_torch.topology import (
    Building,
    City,
    build_city,
    generate_wraparound,
    hex_cell_centers,
    load_city_json,
    save_city_json,
    synthetic_city,
    wraparound_distance,
)


def square_building(cx, cy, half, height):
    fp = np.array(
        [
            [cx - half, cy - half],
            [cx + half, cy - half],
            [cx + half, cy + half],
            [cx - half, cy + half],
        ]
    )
    return Building(floor_plan=fp, height=height, loss_db=20.0)


# ------------------------------------------------------- tests/test_topology.py


class TestLoS:
    def test_wall_blocks_segment(self):
        city = City(buildings=[square_building(0, 0, 10, 30)])
        a = np.array([[-50.0, 0.0, 1.5]])
        b = np.array([[50.0, 0.0, 25.0]])
        assert not city.check_los(a, b)[0]

    def test_above_building_is_los(self):
        city = City(buildings=[square_building(0, 0, 10, 30)])
        a = np.array([[-50.0, 0.0, 40.0]])
        b = np.array([[50.0, 0.0, 45.0]])
        assert city.check_los(a, b)[0]

    def test_beside_building_is_los(self):
        city = City(buildings=[square_building(0, 0, 10, 30)])
        a = np.array([[-50.0, 30.0, 1.5]])
        b = np.array([[50.0, 30.0, 25.0]])
        assert city.check_los(a, b)[0]

    def test_ceiling_crossing_blocked(self):
        city = City(buildings=[square_building(0, 0, 10, 30)])
        a = np.array([[0.0, 0.0, 100.0]])
        b = np.array([[0.0, 0.0, 10.0]])
        assert not city.check_los(a, b)[0]

    def test_vectorized_many_links(self):
        city = City(buildings=[square_building(0, 0, 10, 30)])
        n = 64
        rng = np.random.default_rng(0)
        a = np.column_stack([np.full(n, -50.0), rng.uniform(-40, 40, n), np.full(n, 1.5)])
        b = np.column_stack([np.full(n, 50.0), a[:, 1], np.full(n, 25.0)])
        los = city.check_los(a, b)
        blocked = np.abs(a[:, 1]) < 9.5
        assert not los[blocked].any()
        clear = np.abs(a[:, 1]) > 10.5
        assert los[clear].all()

    def test_penetration_loss_counts_walls(self):
        city = City(buildings=[square_building(0, 0, 10, 30)])
        a = np.array([[-50.0, 0.0, 1.5]])
        b = np.array([[50.0, 0.0, 1.5]])
        assert city.penetration_loss_db(a, b)[0] == pytest.approx(40.0)


class TestCityIO:
    def test_json_round_trip(self, tmp_path):
        city = synthetic_city(x_span=200, y_span=200, seed=3)
        p = tmp_path / "city.json"
        save_city_json(city, str(p))
        loaded = load_city_json(str(p))
        assert len(loaded.buildings) == len(city.buildings)
        np.testing.assert_allclose(loaded.buildings[0].floor_plan, city.buildings[0].floor_plan)
        a = np.array([[-90.0, 5.0, 1.5], [-90.0, 5.0, 80.0]])
        b = np.array([[90.0, -5.0, 10.0], [90.0, -5.0, 85.0]])
        np.testing.assert_array_equal(loaded.check_los(a, b), city.check_los(a, b))

    def test_reference_schema_fields(self, tmp_path):
        city = synthetic_city(x_span=150, y_span=150, seed=1)
        p = tmp_path / "c.json"
        save_city_json(city, str(p))
        d = json.load(open(p))
        assert set(d) == {"buildings", "streetSystem"}
        b = d["buildings"][0]
        assert set(b) == {"name", "floorPlan", "height", "loss"}
        assert len(b["floorPlan"]) == 2  # [x_row, y_row]

    def test_build_city_synthetic_fallback(self):
        city = build_city(t_params.CityParams(), t_params.RegionOfInterest(x_span=300, y_span=300))
        assert len(city.buildings) > 0
        hts = [b.height for b in city.buildings]
        assert min(hts) >= 10.0 and max(hts) <= 40.0


class TestWraparound:
    def test_hex_centers_count_and_spacing(self):
        c = hex_cell_centers(7, 500.0)
        assert c.shape == (7, 2)
        d = np.linalg.norm(c[1:] - c[0], axis=1)
        np.testing.assert_allclose(d, 500.0, rtol=1e-9)

    def test_hex_centers_unique(self):
        c = hex_cell_centers(19, 500.0)
        d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
        d[np.arange(19), np.arange(19)] = 1e9
        assert d.min() > 499.0

    def test_generate_wraparound_layout(self):
        lay = generate_wraparound(3, 500.0, ues_per_cell=4, seed=0)
        assert lay["gnb_positions"].shape == (3, 2)
        assert lay["ue_positions"].shape == (3, 4, 3)
        r = np.linalg.norm(lay["ue_positions"][..., :2] - lay["gnb_positions"][:, None], axis=-1)
        assert (r <= 500.0 / np.sqrt(3.0) + 1e-9).all()
        assert lay["sector_azimuths_deg"].shape == (3,)

    def test_wraparound_distance_leq_direct(self):
        gnb = hex_cell_centers(7, 500.0)
        ue = np.array([[1200.0, 0.0], [0.0, 900.0]])
        dist, az = wraparound_distance(ue, gnb, num_rings=1, inter_site_distance=500.0)
        direct = np.linalg.norm(ue[:, None] - gnb[None], axis=-1)
        assert (dist <= direct + 1e-9).all()
        assert az.shape == dist.shape


# ------------------------------------------------------- exact parity with JAX's


@pytest.fixture(scope="module")
def cities():
    """The shipped scenario's synthetic city in both packages."""
    return (j_topo.build_city(j_params.CityParams(), j_params.RegionOfInterest()),
            t_topo.build_city(t_params.CityParams(), t_params.RegionOfInterest()))


def _segments(city):
    """~1000 segments over the city: random ones from ground to rooftop
    height, ones that end on a wall corner, ones that run along a wall (the
    parallel guard) and vertical ones through roofs (the ceiling test)."""
    rng = np.random.default_rng(11)
    n = 600
    a = np.column_stack([rng.uniform(-500, 500, (n, 2)), rng.uniform(0, 3, n)])
    b = np.column_stack([rng.uniform(-500, 500, (n, 2)), rng.uniform(0, 45, n)])
    corners, along_a, along_b, vert_a, vert_b = [], [], [], [], []
    for bl in city.buildings[:100]:
        fp = bl.floor_plan
        corners.append([*fp[0], 0.5 * bl.height])
        along_a.append([*(fp[0] - 0.5 * (fp[1] - fp[0])), 1.5])  # collinear with wall 0
        along_b.append([*(fp[1] + 0.5 * (fp[1] - fp[0])), 1.5])
        c = fp.mean(axis=0)
        vert_a.append([*c, bl.height + 10.0])
        vert_b.append([*c, bl.height - 1.0])
    corners = np.asarray(corners)
    k = corners.shape[0]
    a = np.concatenate([a, np.column_stack([rng.uniform(-500, 500, (k, 2)), np.full(k, 1.5)]),
                        np.asarray(along_a), np.asarray(vert_a)])
    b = np.concatenate([b, corners, np.asarray(along_b), np.asarray(vert_b)])
    return a, b


def test_synthetic_city_equal(cities):
    jc, tc = cities
    assert len(jc.buildings) == len(tc.buildings) == 155
    for jb, tb in zip(jc.buildings, tc.buildings):
        np.testing.assert_array_equal(tb.floor_plan, jb.floor_plan)
        assert (tb.height, tb.name, tb.loss_db) == (jb.height, jb.name, jb.loss_db)
    np.testing.assert_array_equal(tc.streets.node_locations, jc.streets.node_locations)
    np.testing.assert_array_equal(tc.streets.connection_matrix, jc.streets.connection_matrix)
    assert tc.to_json_dict() == jc.to_json_dict()


@pytest.mark.parametrize("method", ["blockage_count", "check_los", "penetration_loss_db"])
def test_segment_queries_equal(cities, method):
    jc, tc = cities
    a, b = _segments(jc)
    assert a.shape[0] >= 900
    want = getattr(jc, method)(a, b)
    got = getattr(tc, method)(a, b)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if method == "check_los":  # both outcomes occur
        assert want.any() and not want.all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_city_json_interchangeable(tmp_path, writer):
    seed = 3 if writer == "jax" else 4
    city = (j_topo if writer == "jax" else t_topo).synthetic_city(x_span=300, y_span=300,
                                                                   seed=seed)
    p = str(tmp_path / "city.json")
    (j_topo if writer == "jax" else t_topo).save_city_json(city, p)
    jl, tl = j_topo.load_city_json(p), t_topo.load_city_json(p)
    assert tl.to_json_dict() == jl.to_json_dict() == city.to_json_dict()
    a, b = _segments(city)
    np.testing.assert_array_equal(tl.blockage_count(a, b), jl.blockage_count(a, b))
    np.testing.assert_array_equal(tl.penetration_loss_db(a, b), jl.penetration_loss_db(a, b))


def test_osm_helpers_equal():
    lat, lon = np.array([39.90, 39.905, 39.91]), np.array([116.3575, 116.36, 116.3675])
    for got, want in zip(t_topo.latlon_to_meters(lat, lon, 39.9, 116.3575),
                         j_topo.latlon_to_meters(lat, lon, 39.9, 116.3575)):
        np.testing.assert_array_equal(got, want)
    assert t_topo.overpass_query(1, 2, 3, 4) == j_topo.overpass_query(1, 2, 3, 4)


@pytest.mark.parametrize("n", [1, 7, 19])
def test_hex_cell_centers_equal(n):
    np.testing.assert_array_equal(t_topo.hex_cell_centers(n, 500.0),
                                  j_topo.hex_cell_centers(n, 500.0))


@pytest.mark.parametrize("num_cells,ues,seed", [(3, 4, 0), (7, 5, 2)])
def test_generate_wraparound_equal(num_cells, ues, seed):
    want = j_topo.generate_wraparound(num_cells, 500.0, ues_per_cell=ues, seed=seed)
    got = t_topo.generate_wraparound(num_cells, 500.0, ues_per_cell=ues, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_wraparound_distance_equal():
    rng = np.random.default_rng(5)
    gnb = t_topo.hex_cell_centers(7, 500.0)
    ue = rng.uniform(-1500, 1500, (200, 2))
    for got, want in zip(t_topo.wraparound_distance(ue, gnb, 1, 500.0),
                         j_topo.wraparound_distance(ue, gnb, 1, 500.0)):
        np.testing.assert_array_equal(got, want)


def test_same_public_surface():
    assert t_topo.__all__ == j_topo.__all__
