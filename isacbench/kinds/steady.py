"""One co-channel network drop run as a lockstep timeline.

Set-up builds the drop as ``network_simulation`` does (the scenario function,
``assign_cell_parameters``, ``resolve_los_cross``, ``SyncNetworkRunner``),
with the timeline set to the traffic's ``frames`` before the cells are
assigned, and builds the runner's cross-cell banks (``_build_banks``, which
``run()`` would otherwise do inside the window). The drop itself (sites, UE
and target positions, line of sight, serving links' CDL draws, traffic
arrivals) comes from the traffic's ``drop_seed``, the same for every run; the
run's seed drives the runner (the cross-cell links' CDL draws, every noise
draw), so that runs of different seeds do the same work with other inputs.
It then warms up the engine's shapes on a separate engine of the first cell
over the traffic's ``warm_slots``, which builds no bank.

The window is ``SyncNetworkRunner.run()``: a fixed amount of work, since the
runner has no entry that runs a range of slots; ``seconds`` is not used.
"""

from __future__ import annotations

import torch

from isacbench.kinds import derived_seed


class State:
    def __init__(self, config, traffic, seed, device, overrides):
        from isac_tpu_torch.config import scenarios
        from isac_tpu_torch.config.params import (
            SimulationParameters,
            TimeParams,
            assign_cell_parameters,
        )
        from isac_tpu_torch.sim.network import SyncNetworkRunner, resolve_los_cross

        s = derived_seed(seed, 2)
        sim = getattr(scenarios, config["scenario"])(
            SimulationParameters(), seed=int(traffic["drop_seed"]),
            **config.get("scenario_kwargs", {}))
        sim.time = TimeParams(num_frames=int(traffic["frames"]))
        sim.validate()
        cells, cross_los = resolve_los_cross(assign_cell_parameters(sim), sim)
        kw = {**traffic.get("engine", {}), **overrides}
        self.cells = cells
        self.runner = SyncNetworkRunner(cells, seed=s, cross_los=cross_los, device=device, **kw)
        self.runner._build_banks()
        self.bank_build_s = self.runner.stage_s["banks"]
        self.seed = s
        self.device = device
        self.engine_kwargs = kw

    def warm_up(self, n_slots: int):
        from isac_tpu_torch.sim.cell import CellSimulator

        eng = CellSimulator(self.cells[0], seed=self.seed, device=self.device,
                            **self.engine_kwargs)
        eng.run(0, n_slots, finalize=False)

    def counters(self) -> dict:
        return {"stage_s": dict(self.runner.stage_s), "bank_build_s": self.bank_build_s,
                "num_slots": self.runner.num_slots}


def setup(config, traffic, seed, device, overrides) -> State:
    st = State(config, traffic, seed, device, overrides)
    st.warm_up(int(traffic["warm_slots"]))
    return st


def window(st: State, seconds: float):
    st.runner.run()
    return 1, len(st.runner.sims) * st.runner.num_slots


def release(st: State):
    del st.runner
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
