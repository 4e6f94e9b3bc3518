"""Symbol scheduling (TTI 4: 4 + 4 + 4 + 2 symbol grants with mid-slot DM-RS)
of the port's engine against the JAX engine, on the shipped city cell at
24 PRB / nfft 512: traces, KPIs and logs under test_torch_cell.py's rules.
test_torch_cell_layouts.py holds the same mode to the reference test's
thresholds at 51 PRB.
"""

import torch

from test_torch_cell import assert_runs_equal, run_engine

torch.set_num_threads(1)


def test_tti4_equals_jax():
    port = run_engine(True, "open_street_map_city", "TTI4")
    assert_runs_equal(run_engine(False, "open_street_map_city", "TTI4"), port)
    sim = port[0]
    assert sim.symbol_sched and sim.tti == 4
    starts = {g["sym_start"] for g in sim.sched_log.grants if g["dir"] == "DL"}
    assert {0, 4, 8, 12} <= starts, starts
