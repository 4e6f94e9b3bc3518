"""One cell's slot loop run frame by frame on one engine.

Set-up builds one drop as ``api.simulate`` does (the scenario function,
``assign_cell_parameters``, ``resolve_los``) from the traffic's
``drop_seed``, the same for every run, with the timeline set to the
traffic's ``frames`` before the cell is assigned. It then constructs one
``CellSimulator`` whose seed, and whose serving links' CDL seed, derive from
the run's seed: the drop (UE and target positions, line of sight, traffic)
is fixed, and the run's seed drives the fading draws and every noise draw.
It warms up on the same engine over the first ``warm_slots`` slots.

The window steps ``CellSimulator.run(s, s + frame, finalize=False)`` one
frame at a time from the end of the warm-up until ``seconds`` have passed;
the frame that is running then finishes and counts. The timeline's end also
ends the window. No construction, no post-pass, no network runner.
"""

from __future__ import annotations

import time
from dataclasses import replace

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
        from isac_tpu_torch.sim.cell import CellSimulator
        from isac_tpu_torch.sim.network import resolve_los

        sim = getattr(scenarios, config["scenario"])(
            SimulationParameters(), seed=int(traffic["drop_seed"]),
            **config.get("scenario_kwargs", {}))
        sim.time = TimeParams(num_frames=int(traffic["frames"]))
        sim.validate()
        (cell,) = resolve_los(assign_cell_parameters(sim), sim)
        s = derived_seed(seed, 3)
        cell = cell.with_(cdl=replace(cell.cdl, seed=s))
        kw = {**traffic.get("engine", {}), **overrides}
        self.engine = CellSimulator(cell, seed=s, device=device, **kw)
        self.frame = self.engine.carrier.slots_per_frame
        self.next_slot = 0

    def run_frame(self, n_slots: int):
        stop = min(self.next_slot + n_slots, self.engine.num_slots)
        self.engine.run(self.next_slot, stop, finalize=False)
        done = stop - self.next_slot
        self.next_slot = stop
        return done

    def counters(self) -> dict:
        return {}


def setup(config, traffic, seed, device, overrides) -> State:
    st = State(config, traffic, seed, device, overrides)
    st.run_frame(int(traffic["warm_slots"]))
    return st


def window(st: State, seconds: float):
    t_end = time.perf_counter() + seconds
    frames = slots = 0
    while st.next_slot < st.engine.num_slots:
        slots += st.run_frame(st.frame)
        frames += 1
        if time.perf_counter() >= t_end:
            break
    return frames, slots


def release(st: State):
    del st.engine
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
