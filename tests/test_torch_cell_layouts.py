"""Grant layouts whose reference run costs a second JAX compile of every
receive program: symbol scheduling (TTI 4: 4 + 4 + 4 + 2 symbol grants with
mid-slot DM-RS) and a 4-port gNB (TS 38.211 row-5 CSI-RS, CDM-FD2). The port
is held to the reference test's own assertions at its size, 51 PRB / nfft
1024 (tests/test_e2e.py::test_symbol_scheduling_tti_grants and
::test_four_port_cell_uses_row5_csirs).
"""

import pytest
import torch

from test_torch_cell import run_engine

torch.set_num_threads(1)

E2E = dict(n_rb_override=51, nfft_override=1024)


def _tti4(sim, res):
    comm = res["communication"]
    assert sim.symbol_sched and sim.tti == 4
    starts = {(g["sym_start"], g["n_sym"]) for g in sim.sched_log.grants if g["dir"] == "DL"}
    assert {(0, 4), (4, 4), (8, 4), (12, 2)} <= starts, starts
    assert comm["ueDLThroughputMbps"][0] > 25.0, comm["ueDLThroughputMbps"]
    assert comm["ueDLBLER"][0] <= 0.15


def _row5(sim, res):
    comm = res["communication"]
    assert sim.csirs_row5 and sim.n_tx == 4
    assert sim.csirs_reserved == ((5, 0), (5, 1), (6, 0), (6, 1))
    assert comm["ueDLThroughputMbps"][0] > 10.0
    assert comm["ueDLBLER"][0] < 0.2


@pytest.mark.parametrize("mode,check", [("TTI4", _tti4), ("row5", _row5)], ids=["TTI4", "row5"])
def test_mode_meets_reference_assertion(mode, check):
    check(*run_engine(True, "single_link", mode, **E2E))
