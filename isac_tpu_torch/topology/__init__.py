"""Scenario / topology layer (L3): blockage geometry, LoS, OSM city,
wraparound hex layout (+networkTopology/ in the reference; SURVEY §2.3).
Host numpy throughout: LoS booleans are scenario constants, not device work."""

from isac_tpu_torch.topology.blockages import Building, City, StreetSystem
from isac_tpu_torch.topology.osm import (
    build_city,
    latlon_to_meters,
    load_city_json,
    overpass_query,
    save_city_json,
    synthetic_city,
)
from isac_tpu_torch.topology.wraparound import (
    generate_wraparound,
    hex_cell_centers,
    wraparound_distance,
)

__all__ = [
    "Building",
    "City",
    "StreetSystem",
    "build_city",
    "latlon_to_meters",
    "load_city_json",
    "overpass_query",
    "save_city_json",
    "synthetic_city",
    "generate_wraparound",
    "hex_cell_centers",
    "wraparound_distance",
]
