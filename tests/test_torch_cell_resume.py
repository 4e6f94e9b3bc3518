"""The port's engine on its own: the committed golden trace, and a
checkpoint / pickle / restore / resume that equals the straight run.

The golden trace (tests/golden/single_link_trace.json) is the reference
engine's fixed-seed single-link run at 51 PRB / nfft 1024; the port must
reproduce it under the rule of tests/test_e2e.py::test_fixed_seed_golden_trace
(integer fields exact, post-equalisation SINR within 0.1 dB).
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from isac_tpu_torch.sim.cell import CellSimulator as PortCell
from test_torch_cell import (
    SMALL,
    TRACE_INT_KEYS,
    assert_kpis_equal,
    assert_logs_equal,
    run_engine,
    scenario_cell,
)

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / "single_link_trace.json"


def test_golden_trace_reproduced():
    golden = json.loads(GOLDEN.read_text())
    sim = PortCell(scenario_cell(True, "single_link"), n_rb_override=golden["n_rb"],
                   nfft_override=golden["nfft"], seed=golden["seed"], device="cpu")
    sim.run()
    assert len(sim.metrics.trace) == len(golden["trace"])
    for got, exp in zip(sim.metrics.trace, golden["trace"]):
        for k in TRACE_INT_KEYS:
            assert got[k] == exp[k], (k, got, exp)
        assert abs(float(got["sinr_db"]) - exp["sinr_db"]) < 0.1, (got, exp)


@pytest.fixture(scope="module")
def port_city():
    return run_engine(True, "open_street_map_city")


def test_checkpoint_resume_equals_straight_run(port_city):
    """Checkpoint at slot 10, pickle, restore into a fresh simulator (numpy
    soft buffers, deferred results and sensing grids), resume: the same
    traces, KPIs, logs and sensing estimates as the straight run."""
    straight_sim, straight = port_city
    first = PortCell(scenario_cell(True, "open_street_map_city"), device="cpu", **SMALL)
    first.run(stop_slot=10, finalize=False)
    assert first._deferred and first._sen_slots  # device state crosses the boundary
    blob = pickle.dumps(first.checkpoint(next_slot=10))
    second = PortCell(scenario_cell(True, "open_street_map_city"), device="cpu", **SMALL)
    resumed = second.run(start_slot=second.restore(pickle.loads(blob)))
    assert second.metrics.trace == straight_sim.metrics.trace  # SINR bit-equal too
    assert_kpis_equal(straight["communication"], resumed["communication"])
    assert_logs_equal(straight["logs"], resumed["logs"])
    for k, v in straight["sensing"]["estimates"].items():
        np.testing.assert_array_equal(resumed["sensing"]["estimates"][k].numpy(), v.numpy(),
                                      err_msg=k)
    assert resumed["sensing"]["rmse"]["rngRMSE"] == straight["sensing"]["rmse"]["rngRMSE"]

