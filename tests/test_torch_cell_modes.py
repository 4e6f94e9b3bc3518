"""Engine modes of the port against the reference engine: RLC AM (STATUS
PDUs in-band, polling, retransmission) and fast_csi (truth-channel CSI with
the reference's estimation noise draws), on the single-link scenario at
24 PRB / nfft 512 — traces, KPIs and logs under test_torch_cell.py's rules.
"""

import pytest
import torch

from test_torch_cell import assert_runs_equal, run_engine

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["AM", "fast_csi"])
def test_mode_equals_jax(mode):
    port = run_engine(True, "single_link", mode)
    assert_runs_equal(run_engine(False, "single_link", mode), port)
    if mode == "AM":
        gnb, ue = port[0].rlc_gnb[0], port[0].rlc_ue[0]
        assert ue.stats.status_tx > 0 and gnb.stats.status_rx > 0  # STATUS rode the UL
