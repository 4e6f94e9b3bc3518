"""Parity of the port's host-side configuration layer with isac_tpu: carrier
numerology, the parameter dataclasses, the scenario functions, the spectral
windows and the geometry helpers.

All of it is numpy/float64 or integer code that the port keeps its own copy
of, so integers and strings are compared exactly and floats to 1e-12 (the two
copies run the same numpy calls; the bound only allows for nothing at all).
"""

import dataclasses

import numpy as np
import pytest

from isac_tpu import config as j_cfg
from isac_tpu.config import scenarios as j_scen
from isac_tpu.utils import geometry as j_geo
from isac_tpu.utils import windows as j_win
from isac_tpu_torch import config as t_cfg
from isac_tpu_torch.config import scenarios as t_scen
from isac_tpu_torch.utils import geometry as t_geo
from isac_tpu_torch.utils import windows as t_win

FLOAT_TOL = 1e-12


def _same(a, b, path="value"):
    """Field-by-field equality of two objects of the two packages: dataclasses
    by field name, containers by element, floats to FLOAT_TOL."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            _same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=FLOAT_TOL, abs=0), path
    else:
        assert a == b, path


@pytest.mark.parametrize("fc,bw,scs", [
    (3.5e9, 100e6, 30), (3.5e9, 20e6, 30), (3.5e9, 20e6, 15), (2.1e9, 10e6, 60),
    (3.5e9, 50e6, 15), (28e9, 100e6, 120), (28e9, 400e6, 120), (39e9, 50e6, 60),
])
def test_determine_prb_equal(fc, bw, scs):
    assert t_cfg.determine_prb(fc, bw, scs) == j_cfg.determine_prb(fc, bw, scs)
    assert t_cfg.frequency_range(fc) == j_cfg.frequency_range(fc)


def test_prb_tables_equal():
    from isac_tpu.config import carrier as jc
    from isac_tpu_torch.config import carrier as tc

    assert tc.PRB_TABLE_FR1 == jc.PRB_TABLE_FR1 and tc.PRB_TABLE_FR2 == jc.PRB_TABLE_FR2


@pytest.mark.parametrize("fc,bw,scs", [(10e9, 100e6, 30), (3.5e9, 35e6, 30), (3.5e9, 100e6, 15)])
def test_determine_prb_rejects_like_the_reference(fc, bw, scs):
    with pytest.raises(ValueError) as et:
        t_cfg.determine_prb(fc, bw, scs)
    with pytest.raises(ValueError) as ej:
        j_cfg.determine_prb(fc, bw, scs)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("n_rb,scs,nfft", [
    (273, 30, None), (51, 30, None), (24, 30, None), (106, 15, None), (52, 15, 2048),
    (11, 60, None), (66, 120, None),
])
def test_ofdm_info_equal(n_rb, scs, nfft):
    a, b = t_cfg.ofdm_info(n_rb, scs, nfft), j_cfg.ofdm_info(n_rb, scs, nfft)
    _same(a, b)
    assert a.symbols_per_subframe == b.symbols_per_subframe
    assert a.subframe_samples == b.subframe_samples
    for num_slots, first in ((1, 0), (4, 0), (3, 1), (5, 7)):
        np.testing.assert_array_equal(a.cp_lengths_slots(num_slots, first),
                                      b.cp_lengths_slots(num_slots, first))
        np.testing.assert_array_equal(a.symbol_starts(num_slots, first),
                                      b.symbol_starts(num_slots, first))
        assert a.slot_samples(first) == b.slot_samples(first)
    # a half-subframe is exactly 0.5 ms of samples
    spf = a.slots_per_subframe
    assert a.symbol_lengths_slots(spf, 0).sum() == a.subframe_samples


def test_ofdm_info_rejects_small_nfft():
    with pytest.raises(ValueError):
        t_cfg.ofdm_info(51, 30, 512)


@pytest.mark.parametrize("pattern,dl,ul", [("DDDSU", 10, 2), ("DDSUU", 6, 4), ("DDDDDDDSUU", 10, 2),
                                           ("D", 10, 2), ("DU", 3, 3)])
def test_parse_tdd_pattern_equal(pattern, dl, ul):
    a, b = t_cfg.parse_tdd_pattern(pattern, dl, ul), j_cfg.parse_tdd_pattern(pattern, dl, ul)
    _same(a, b)
    assert a.has_special == b.has_special and a.dl_ratio() == b.dl_ratio()
    assert [a.slot_type(s) for s in range(12)] == [b.slot_type(s) for s in range(12)]


def test_parse_tdd_pattern_rejects_bad_chars():
    with pytest.raises(ValueError):
        t_cfg.parse_tdd_pattern("DDXSU")


@pytest.mark.parametrize("kw", [
    {}, dict(dl_bandwidth=20e6, ul_bandwidth=20e6),
    dict(scs_khz=15, dl_bandwidth=20e6, tdd_pattern="DDSUU", tdd_special_slot=(6, 4, 4)),
    dict(dl_carrier_freq=28e9, dl_bandwidth=100e6, scs_khz=120, cell_id=7),
])
def test_gnb_params_derived_equal(kw):
    a, b = t_cfg.GNBParams(**kw), j_cfg.GNBParams(**kw)
    _same(a, b)
    _same(a.tdd, b.tdd)
    ca, cb = a.carrier, b.carrier
    _same(ca, cb)
    _same(ca.ofdm, cb.ofdm)
    for prop in ("n_rb", "n_sc", "mu", "slots_per_frame", "slot_duration_s",
                 "symbols_per_slot", "wavelength"):
        assert getattr(ca, prop) == getattr(cb, prop), prop
    assert (a.num_tx_ants, a.num_rx_ants, a.bs_type) == (b.num_tx_ants, b.num_rx_ants, b.bs_type)


@pytest.mark.parametrize("kind,kw", [
    ("ULA", dict(n_v=8, polarizations=2)), ("ULA", dict(n_v=4, polarizations=1, spacing=0.7)),
    ("ULA", dict(n_v=4, spacing_meters=0.03)),
    ("UPA", dict(n_v=2, n_h=4)), ("UPA", dict(n_v=4, n_h=2, n_pv=2, n_ph=2, polarizations=1)),
])
def test_antenna_arrays_equal(kind, kw):
    a, b = getattr(t_cfg, kind)(**kw), getattr(j_cfg, kind)(**kw)
    _same(a, b)
    assert a.num_elements == b.num_elements
    np.testing.assert_allclose(a.element_positions(0.0857), b.element_positions(0.0857),
                               rtol=FLOAT_TOL, atol=0)


@pytest.mark.parametrize("name", [
    "RadarConfig", "UEParams", "TargetParams", "SchedulingParams", "TrafficParams",
    "PathlossParams", "CDLParams", "CityParams", "RegionOfInterest", "TimeParams", "LogParams",
    "SimulationParameters", "CarrierConfig",
])
def test_parameter_defaults_equal(name):
    _same(getattr(t_cfg, name)(), getattr(j_cfg, name)())


def test_region_and_time_properties_equal():
    a, b = t_cfg.RegionOfInterest(800.0, 600.0), j_cfg.RegionOfInterest(800.0, 600.0)
    assert (a.x_min, a.x_max, a.y_min, a.y_max) == (b.x_min, b.x_max, b.y_min, b.y_max)
    for scs in (15, 30, 60, 120):
        assert t_cfg.TimeParams(3).num_slots(scs) == j_cfg.TimeParams(3).num_slots(scs)


SCENARIOS = [
    ("open_street_map_city", dict(seed=0)), ("open_street_map_city", dict(seed=5)),
    ("single_link", dict(num_frames=2, seed=1)), ("sensing_only", dict(num_frames=1, seed=2)),
    ("multi_ue_cell", dict(num_ues=8, seed=3)), ("multi_cell", dict(num_cells=2, seed=0)),
    ("multi_cell", dict(num_cells=9, seed=4)),
]


@pytest.mark.parametrize("fn,kw", SCENARIOS)
def test_scenarios_equal(fn, kw):
    a = getattr(t_scen, fn)(t_cfg.SimulationParameters(), **kw)
    b = getattr(j_scen, fn)(j_cfg.SimulationParameters(), **kw)
    _same(a, b)
    assert a.cell_names() == b.cell_names()


@pytest.mark.parametrize("fn,kw", SCENARIOS[:6])
def test_assign_cell_parameters_equal(fn, kw):
    a = t_cfg.assign_cell_parameters(getattr(t_scen, fn)(t_cfg.SimulationParameters(), **kw))
    b = j_cfg.assign_cell_parameters(getattr(j_scen, fn)(j_cfg.SimulationParameters(), **kw))
    _same(a, b)
    assert [c.num_slots for c in a] == [c.num_slots for c in b]
    assert a[0].with_(name="x").name == "x"


def test_predefined_positions_and_validate():
    kw = dict(position_mode="predefined", positions=((10.0, 20.0, 1.5), (-30.0, 5.0, 1.5)))
    sims = []
    for cfg, scen in ((t_cfg, t_scen), (j_cfg, j_scen)):
        sim = scen.open_street_map_city(cfg.SimulationParameters())
        sim.ue["cell1"] = cfg.UEParams(num_ues=2, **kw)
        sim.target["cell1"] = cfg.TargetParams(num_targets=2, rcs_m2=(1.0, 2.0),
                                               velocity_ms=(3.0, -4.0), **kw)
        sims.append(cfg.assign_cell_parameters(sim))
    _same(sims[0], sims[1])
    bad = t_scen.open_street_map_city(t_cfg.SimulationParameters())
    bad.ue["cell2"] = t_cfg.UEParams()
    with pytest.raises(ValueError):
        bad.validate()


@pytest.mark.parametrize("kind", ["kaiser", "hamming", "hann", "blackman", "gausswin",
                                  "tukeywin", "barthannwin", "rect"])
@pytest.mark.parametrize("n", [17, 256])
def test_windows_equal(kind, n):
    a, b = t_win.window(kind, n), j_win.window(kind, n)
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=0)
    assert np.array_equal(t_win.window(kind.upper(), n), a)  # the name is case-blind


def test_window_rejects_unknown_kind():
    with pytest.raises(ValueError):
        t_win.window("chebwin", 8)


def test_geometry_equal():
    rng = np.random.default_rng(11)
    xyz = rng.normal(0.0, 200.0, (3, 50))
    for got, want in zip(t_geo.cart2sph(*xyz), j_geo.cart2sph(*xyz)):
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=0)
    az, el, r = j_geo.cart2sph(*xyz)
    for got, want in zip(t_geo.sph2cart(az, el, r), j_geo.sph2cart(az, el, r)):
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=0)
    np.testing.assert_allclose(np.stack(t_geo.sph2cart(az, el, r)), xyz, rtol=1e-9, atol=1e-9)
    c = np.array([12.0, -7.0])
    np.testing.assert_allclose(t_geo.hexagon_vertices(c, 150.0), j_geo.hexagon_vertices(c, 150.0),
                               rtol=FLOAT_TOL, atol=0)
    pts = rng.uniform(-200.0, 200.0, (400, 2)) + c
    inside = t_geo.point_in_hexagon(pts, c, 150.0)
    np.testing.assert_array_equal(inside, j_geo.point_in_hexagon(pts, c, 150.0))
    assert 0 < inside.sum() < 400
    for exact, dens in ((True, 9), (False, 2e-4)):
        a = t_geo.poisson_points_2d(np.random.default_rng(3), c, 150.0, dens, 1.5, exact)
        b = j_geo.poisson_points_2d(np.random.default_rng(3), c, 150.0, dens, 1.5, exact)
        np.testing.assert_allclose(a, b, rtol=FLOAT_TOL, atol=0)
        assert t_geo.point_in_hexagon(a[:, :2], c, 150.0).all()
    x = np.array([0.5, 3.0, 44.0])
    for name in ("db2pow", "pow2db", "db2mag", "mag2db"):
        np.testing.assert_allclose(getattr(t_geo, name)(x), getattr(j_geo, name)(x),
                                   rtol=FLOAT_TOL, atol=0)
    assert t_geo.SPEED_OF_LIGHT == j_geo.SPEED_OF_LIGHT and t_geo.BOLTZMANN == j_geo.BOLTZMANN
