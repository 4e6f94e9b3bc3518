"""Top-level simulate() entry point (counterpart of isac_tpu/api.py; the
reference's simulate.m:1-24).

results = simulate(scenario_fn) builds default SimulationParameters, applies
the scenario function, runs the network simulation and returns
{"cells": [per-cell result], "network": aggregate KPIs}. `device` passes
through to network_simulation with the other keyword arguments; None means
the card (raises without one). The scenario function runs inside the span
``build.scenario`` (utils/tracing.py).
"""

from __future__ import annotations

from isac_tpu_torch.config.params import SimulationParameters
from isac_tpu_torch.utils import tracing


def simulate(scenario_fn, enable_parallel_sim: bool = False, **kwargs):
    from isac_tpu_torch.sim.network import network_simulation

    with tracing.span("build.scenario"):
        sim_params = SimulationParameters()
        sim_params = scenario_fn(sim_params) or sim_params
    return network_simulation(sim_params, enable_parallel_sim=enable_parallel_sim, **kwargs)
