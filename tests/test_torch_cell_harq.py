"""HARQ retransmission in the port's engine against isac_tpu's.

The single link of config/scenarios.py at 24 PRB / nfft 512 with the gNB at
10 dBm and the UE at -35 dBm: blocks fail in both directions, their soft
buffers go back into the batched receive, and the rv-3 retransmissions pass
on the combined buffers. The port's run equals the reference engine's (under
the rules of test_torch_cell.py), and a checkpoint taken while soft buffers
wait resumes to the straight run.
"""

import pickle

import numpy as np
import pytest
import torch

from isac_tpu_torch.sim.cell import CellSimulator as PortCell
from test_torch_cell import (
    SMALL,
    assert_kpis_equal,
    assert_logs_equal,
    assert_runs_equal,
    run_engine,
    scenario_cell,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_retx():
    return run_engine(False, "single_link", "retx")


@pytest.fixture(scope="module")
def port_retx():
    return run_engine(True, "single_link", "retx")


def test_retx_equal_jax(jax_retx, port_retx):
    """Failed CRCs, soft buffers fed back into the batched receive and
    retransmissions that pass on the combined buffers, in both directions:
    the same traces, KPIs and logs as the reference engine."""
    assert_runs_equal(jax_retx, port_retx)
    trace = port_retx[0].metrics.trace
    for d in ("DL", "UL"):
        assert any(not t["crc"] for t in trace if t["dir"] == d), d
        assert any(t["rv"] != 0 and t["crc"] for t in trace if t["dir"] == d), d


def test_retx_checkpoint_resume_equals_straight_run(port_retx):
    """Checkpoint at slot 10 while DL soft buffers wait for their
    retransmission and the UL decode of slot 9 (due at slot 10) is still on
    the device: both cross the boundary as numpy, go back to the device where
    they are used, and the resumed run equals the straight one."""
    straight_sim, straight = port_retx
    first = PortCell(scenario_cell(True, "single_link", "retx"), device="cpu", **SMALL)
    first.run(stop_slot=10, finalize=False)
    assert first.rx_soft_bufs
    assert all(torch.is_tensor(b) for b in first.rx_soft_bufs.values())
    assert any(e["kind"] == "ul" for e in first._deferred)
    state = pickle.loads(pickle.dumps(first.checkpoint(next_slot=10)))
    assert all(isinstance(b, np.ndarray) for b in state["rx_soft_bufs"].values())
    assert all(isinstance(e["share"]["outs"]["soft_buffers"], np.ndarray)
               for e in state["_deferred"] if e["kind"] == "ul")
    second = PortCell(scenario_cell(True, "single_link", "retx"), device="cpu", **SMALL)
    resumed = second.run(start_slot=second.restore(state))
    assert second.metrics.trace == straight_sim.metrics.trace  # SINR bit-equal too
    for d in ("DL", "UL"):
        assert any(t["rv"] != 0 and t["slot"] >= 10 for t in second.metrics.trace
                   if t["dir"] == d), d
    assert_kpis_equal(straight["communication"], resumed["communication"])
    assert_logs_equal(straight["logs"], resumed["logs"])
