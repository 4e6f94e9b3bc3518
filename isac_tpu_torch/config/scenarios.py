"""Scenario functions — each fills a SimulationParameters aggregate.

Mirrors +scenarios/openStreetMapCity.m:1-119: the shipped scenario is one gNB at
3.5 GHz / 100 MHz / SCS 30 / TDD 'DDDSU', ULA 8x2-pol, 5 Poisson-dropped UEs,
1 target with random velocity, PF scheduler, On-Off traffic, UMa pathloss,
CDL-D (LoS) fading, OSM city bounding box.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from isac_tpu_torch.config.params import (
    CDLParams,
    CityParams,
    GNBParams,
    PathlossParams,
    RadarConfig,
    SchedulingParams,
    SectorGNBParams,
    SimulationParameters,
    TargetParams,
    TimeParams,
    TrafficParams,
    UEParams,
    ULA,
)


def open_street_map_city(sim: SimulationParameters, seed: int = 0) -> SimulationParameters:
    """The reference's single shipped scenario (+scenarios/openStreetMapCity.m)."""
    rng = np.random.default_rng(seed)  # rng('default') analogue (:9)
    name = "cell1"
    sim.time = TimeParams(num_frames=1)
    sim.bs[name] = GNBParams(
        cell_id=1,
        position=(0.0, 0.0, 30.0),
        duplex_mode="TDD",
        scheduling_type="slot",
        dl_carrier_freq=3.5e9,
        ul_carrier_freq=3.5e9,
        dl_bandwidth=100e6,
        ul_bandwidth=100e6,
        scs_khz=30,
        tdd_pattern="DDDSU",
        tx_power_dbm=44.0,
        antenna=ULA(n_v=8, polarizations=2),
        radar=RadarConfig(),
    )
    sim.ue[name] = UEParams(num_ues=5, num_ants=2, drop_radius=200.0, seed=seed)
    # Target with random radial velocity in [2, 10] m/s (:42-52)
    sim.target[name] = TargetParams(
        num_targets=1,
        rcs_m2=(1.0,),
        velocity_ms=(float(rng.uniform(2.0, 10.0)),),
        drop_radius=200.0,
        seed=seed + 1,
    )
    sim.scheduling[name] = SchedulingParams(strategy="PF")
    sim.traffic[name] = TrafficParams(
        model="On-Off", dl_app_data_rate_kbps=40e3, ul_app_data_rate_kbps=10e3, seed=seed + 2
    )
    sim.pathloss[name] = PathlossParams(model="UMa")
    sim.com_channel[name] = CDLParams(delay_profile="CDL-D", delay_spread_ns=300.0)
    sim.city[name] = CityParams()
    return sim


def single_link(sim: SimulationParameters, num_frames: int = 1, seed: int = 0) -> SimulationParameters:
    """BASELINE config #1: one gNB + one UE, comm-only."""
    sim = open_street_map_city(sim, seed=seed)
    sim.ue["cell1"] = UEParams(num_ues=1, num_ants=2, drop_radius=200.0, seed=seed)
    sim.target["cell1"] = TargetParams(num_targets=0, rcs_m2=(), velocity_ms=(), seed=seed + 1)
    sim.time = TimeParams(num_frames=num_frames)
    return sim


def sensing_only(sim: SimulationParameters, num_frames: int = 1, seed: int = 0) -> SimulationParameters:
    """BASELINE config #2: single gNB + 1 target mono-static sensing."""
    sim = open_street_map_city(sim, seed=seed)
    sim.ue["cell1"] = UEParams(num_ues=1, num_ants=2, seed=seed)
    sim.time = TimeParams(num_frames=num_frames)
    return sim


def multi_ue_cell(sim: SimulationParameters, num_ues: int = 8, seed: int = 0) -> SimulationParameters:
    """BASELINE config #3: single cell, 8 UEs, full comm stack."""
    sim = open_street_map_city(sim, seed=seed)
    sim.ue["cell1"] = UEParams(num_ues=num_ues, num_ants=2, drop_radius=200.0, seed=seed)
    return sim


def multi_cell(sim: SimulationParameters, num_cells: int = 2, seed: int = 0,
               num_ues: int = 5, sectors: int = 1) -> SimulationParameters:
    """BASELINE config #5: `num_cells` co-channel copies of the shipped cell
    on the hexagonal grid of sites 500 m apart (the centre site, then ring
    after ring: 7 sites fill the first ring, 19 the second), with `num_ues`
    UEs in every cell, the first included. No wrap-around is applied: the
    outer ring sees only the sites inside the layout.

    `sectors` = 3 gives each of the `num_cells` sites three co-sited TRxPs,
    the ITU-R M.2412 layout (19 sites: 57 TRxPs): TRxP k (cell k + 1) stands
    at site k // 3 with its boresight at 30 + 120 * (k % 3) deg and a
    mechanical downtilt of 12 deg (SectorGNBParams), and its `num_ues` UEs
    are dropped in its 120 deg wedge. Each TRxP takes the seeds a cell k
    takes with one sector; it serves its own drop."""
    from isac_tpu_torch.topology.wraparound import hex_cell_centers

    if sectors not in (1, 3):
        raise ValueError(f"sectors must be 1 or 3, not {sectors}")
    sim = open_street_map_city(sim, seed=seed)
    sim.ue["cell1"] = replace(sim.ue["cell1"], num_ues=num_ues)
    base = sim.bs["cell1"]
    centers = hex_cell_centers(num_cells, inter_site_distance=500.0)
    for i in range(num_cells * sectors):
        name = f"cell{i + 1}"
        site = centers[i // sectors]
        kw = {**base.__dict__, "cell_id": i + 1, "position": (float(site[0]), float(site[1]), 30.0)}
        sim.bs[name] = (GNBParams(**kw) if sectors == 1 else
                        SectorGNBParams(**kw, boresight_deg=30.0 + 120.0 * (i % 3),
                                        downtilt_deg=12.0))
        for m, default in (
            (sim.ue, UEParams(num_ues=num_ues, seed=seed + i)),
            (sim.target, TargetParams(seed=seed + 100 + i)),
            (sim.scheduling, SchedulingParams()),
            (sim.traffic, TrafficParams(seed=seed + 200 + i)),
            (sim.pathloss, PathlossParams()),
            (sim.com_channel, CDLParams()),
        ):
            m.setdefault(name, default)
    return sim
