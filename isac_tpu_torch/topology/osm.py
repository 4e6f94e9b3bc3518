"""OpenStreetMap city construction: JSON cache loader/saver, lat/lon
conversion, Overpass query assembly, and a synthetic city generator
(counterpart of isac_tpu/topology/osm.py; host numpy, the same draws).

Re-design of +networkTopology/+blockages/openStreetMapCity.m:29-241. The
reference fetches buildings/highways from the Overpass API over HTTP and
caches them as dataFiles/blockages/OSM_city.json; this module reads/writes the
same JSON schema (so existing caches work), performs the same WGS-84 lat/lon ->
local-meters conversion (:116-132), draws random building heights, and — for
offline/air-gapped runs — can generate a synthetic Manhattan-grid city with the
same statistics instead of an HTTP fetch.
"""

from __future__ import annotations

import json
import math

import numpy as np

from isac_tpu_torch.topology.blockages import Building, City, StreetSystem

EARTH_RADIUS_M = 6_378_137.0


def latlon_to_meters(lat: np.ndarray, lon: np.ndarray, lat0: float, lon0: float):
    """Equirectangular lat/lon -> local (x, y) meters around (lat0, lon0)
    (openStreetMapCity.m:116-132)."""
    x = np.deg2rad(np.asarray(lon) - lon0) * EARTH_RADIUS_M * math.cos(math.radians(lat0))
    y = np.deg2rad(np.asarray(lat) - lat0) * EARTH_RADIUS_M
    return x, y


def overpass_query(min_lat: float, min_lon: float, max_lat: float, max_lon: float) -> str:
    """The Overpass QL the reference issues for buildings + highways in a bbox
    (openStreetMapCity.m:198-241). Provided for completeness; fetching is the
    caller's concern: nothing here downloads (use the JSON cache or
    synthetic_city)."""
    bbox = f"{min_lat},{min_lon},{max_lat},{max_lon}"
    return (
        "[out:json];("
        f'way["building"]({bbox});'
        f'way["highway"]({bbox});'
        ");out geom;"
    )


def load_city_json(path: str) -> City:
    """Load a city from the reference's OSM_city.json cache schema
    (openStreetMapCity.m:51-64; +parameters/+city/parameters.m:19-29)."""
    with open(path) as f:
        d = json.load(f)
    buildings = []
    for b in d.get("buildings", []):
        fp = np.asarray(b["floorPlan"], dtype=np.float64).T  # [2, n] -> [n, 2]
        loss = b.get("loss") or [20.0]
        buildings.append(
            Building(
                floor_plan=fp,
                height=float(b["height"]),
                name=b.get("name", ""),
                loss_db=float(loss[0]) if len(loss) else 20.0,
            )
        )
    streets = None
    ss = d.get("streetSystem")
    if ss and ss.get("nodeLocations"):
        nodes = np.asarray(ss["nodeLocations"], dtype=np.float64).T
        conn = np.asarray(ss.get("connectionMatrix", np.zeros((len(nodes), len(nodes)))))
        streets = StreetSystem(
            node_locations=nodes,
            connection_matrix=conn.astype(bool),
            street_width=float(ss.get("streetWidth", 10.0)),
            labels=tuple(ss.get("labels", ())),
        )
    return City(buildings=buildings, streets=streets)


def save_city_json(city: City, path: str) -> None:
    with open(path, "w") as f:
        json.dump(city.to_json_dict(), f)


def synthetic_city(
    x_span: float = 500.0,
    y_span: float = 500.0,
    street_width: float = 15.0,
    block_size: float = 60.0,
    min_height: float = 5.0,
    max_height: float = 25.0,
    fill_prob: float = 0.8,
    seed: int = 0,
) -> City:
    """Manhattan-grid synthetic city for offline runs.

    Rectangular buildings on a street grid centered at the origin, heights
    uniform in [min_height, max_height] (matching the reference's random
    heights from cityParameters, +parameters/+city/parameters.m:17 +
    city.m:52 seeded height stream).
    """
    rng = np.random.default_rng(seed)
    pitch = block_size + street_width
    nx = max(int(x_span // pitch), 1)
    ny = max(int(y_span // pitch), 1)
    x0 = -(nx * pitch - street_width) / 2.0
    y0 = -(ny * pitch - street_width) / 2.0
    buildings = []
    for i in range(nx):
        for j in range(ny):
            if rng.uniform() > fill_prob:
                continue
            bx = x0 + i * pitch
            by = y0 + j * pitch
            w = block_size * rng.uniform(0.6, 1.0)
            d = block_size * rng.uniform(0.6, 1.0)
            fp = np.array(
                [[bx, by], [bx + w, by], [bx + w, by + d], [bx, by + d]], dtype=np.float64
            )
            h = float(rng.uniform(min_height, max_height))
            buildings.append(Building(floor_plan=fp, height=h, name=f"b{i}_{j}"))
    # street graph: grid nodes at street crossings
    gx = x0 - street_width / 2.0 + np.arange(nx + 1) * pitch
    gy = y0 - street_width / 2.0 + np.arange(ny + 1) * pitch
    xx, yy = np.meshgrid(gx, gy, indexing="ij")
    nodes = np.stack([xx.ravel(), yy.ravel()], axis=1)
    n = nodes.shape[0]
    conn = np.zeros((n, n), dtype=bool)
    for a in range(n):
        for b in range(a + 1, n):
            dxy = np.abs(nodes[a] - nodes[b])
            if (dxy[0] < 1e-9 and abs(dxy[1] - pitch) < 1e-9) or (
                dxy[1] < 1e-9 and abs(dxy[0] - pitch) < 1e-9
            ):
                conn[a, b] = conn[b, a] = True
    return City(
        buildings=buildings,
        streets=StreetSystem(nodes, conn, street_width=street_width),
    )


def build_city(city_params, roi=None) -> City:
    """Scenario-level city construction (networkSimulation.m generateScenario
    :79-115): JSON cache if configured and present, else synthetic grid."""
    import os

    path = getattr(city_params, "cache_path", None)
    if getattr(city_params, "load_cache", True) and path and os.path.exists(path):
        return load_city_json(path)
    x_span = roi.x_span if roi is not None else 500.0
    y_span = roi.y_span if roi is not None else 500.0
    return synthetic_city(
        x_span=x_span,
        y_span=y_span,
        street_width=getattr(city_params, "street_width", 15.0),
        min_height=getattr(city_params, "min_building_height", 5.0),
        max_height=getattr(city_params, "max_building_height", 25.0),
        seed=getattr(city_params, "height_seed", 0),
    )
