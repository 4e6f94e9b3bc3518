"""Back-to-back Monte-Carlo drops through the top-level entry.

Drop k calls ``isac_tpu_torch.api.simulate`` on the configuration's scenario
function with the seed s_k derived from the run's seed and k, and passes s_k
to ``simulate`` as well: the UE and target drop, the city's line of sight,
the fading and the noise all change from drop to drop. The window runs drops
until ``seconds`` have passed; the drop that is running then finishes and
counts. Set-up runs one drop of its own seed (k = -1), which builds the
decoder and warms up the cell's shapes.
"""

from __future__ import annotations

import time
from functools import partial

import torch
from torch.profiler import record_function

from isacbench.kinds import derived_seed


class State:
    def __init__(self, config, traffic, seed, device, overrides):
        from isac_tpu_torch.api import simulate
        from isac_tpu_torch.config import scenarios
        from isac_tpu_torch.config.params import SimulationParameters

        self.simulate = simulate
        self.scenario = getattr(scenarios, config["scenario"])
        self.scenario_kwargs = dict(config.get("scenario_kwargs", {}))
        self.engine_kwargs = {**traffic.get("engine", {}), **overrides}
        self.seed = seed
        self.device = device
        sim = self.scenario(SimulationParameters(), seed=0, **self.scenario_kwargs)
        self.cell_slots_per_drop = sum(
            sim.time.num_slots(sim.bs[name].scs_khz) for name in sim.cell_names())

    def drop(self, k: int):
        s = derived_seed(self.seed, 1, k + 1)
        fn = partial(self.scenario, seed=s, **self.scenario_kwargs)
        return self.simulate(fn, seed=s, device=self.device, **self.engine_kwargs)

    def counters(self) -> dict:
        return {}


def setup(config, traffic, seed, device, overrides) -> State:
    st = State(config, traffic, seed, device, overrides)
    st.drop(-1)
    return st


def window(st: State, seconds: float):
    t_end = time.perf_counter() + seconds
    k = 0
    while True:
        with record_function("bench.drop"):
            st.drop(k)
        k += 1
        if time.perf_counter() >= t_end:
            break
    return k, k * st.cell_slots_per_drop


def release(st: State):
    del st.simulate
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
