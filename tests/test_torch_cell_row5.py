"""A 4-port gNB (2x2-pol ULA: TS 38.211 row-5 CSI-RS, CDM-FD2) in the port's
engine against the JAX engine, on the shipped city cell at 24 PRB / nfft 512:
traces, KPIs and logs under test_torch_cell.py's rules.
test_torch_cell_layouts.py holds the same mode to the reference test's
thresholds at 51 PRB.
"""

import torch

from test_torch_cell import assert_runs_equal, run_engine

torch.set_num_threads(1)


def test_row5_equals_jax():
    port = run_engine(True, "open_street_map_city", "row5")
    assert_runs_equal(run_engine(False, "open_street_map_city", "row5"), port)
    sim = port[0]
    assert sim.csirs_row5 and sim.n_tx == 4
