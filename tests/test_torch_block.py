"""The port's block mode (isac_tpu_torch/sim/block.py, CellSimulator
block_slots >= 1) against its slot loop, and against the JAX engine, on the
CPU.

Block mode plans a segment's slots on the host, then dispatches their device
work with the slot loop's own device halves, inputs and keys; so every
result surface is the slot loop's bit for bit (`_deep_equal`, as in
tests/test_block.py): KPIs, per-UE metrics, the per-slot trace, the
scheduling logs and the sensing estimates. The shipped city at 24 PRB /
nfft 512 (DDDSU) gives segments of 4 DL slots and 1 U slot with
block_slots=8.

The block run is also held to the JAX engine's slot loop as the cell tests
hold the port's slot loop (tests/test_torch_cell.py: trace integers exact,
SINR within 0.05 dB, KPIs rtol 1e-6, logs exact, sensing bins exact); the
JAX block mode equals that loop by tests/test_block.py. block_slots=1 and a
checkpoint taken in block mode are in test_torch_block_resume.py, FDD in
test_torch_block_fdd.py, fast_csi in test_torch_block_fast_csi.py.
"""

import numpy as np
import pytest
import torch

from test_torch_cell import assert_runs_equal, run_engine

torch.set_num_threads(1)


def deep_equal(a, b, path=""):
    """Exact equality of two result trees (tests/test_block.py `_deep_equal`;
    tensors compare as numpy arrays, NaN equal to NaN)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            deep_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            deep_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    elif isinstance(a, (str, bool, int)):
        assert a == b, (path, a, b)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=True), (
            path, np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)))
            if x.dtype.kind in "fc" else (x, y))


def strip(result):
    """The result without the sensing params (host dataclasses, equal by
    construction)."""
    out = dict(result)
    if out.get("sensing") is not None:
        s = dict(out["sensing"])
        s.pop("params", None)
        out["sensing"] = s
    return out


def assert_block_equals_loop(loop_run, block_run):
    (ls, lr), (bs, br) = loop_run, block_run
    assert len(bs.metrics.trace) > 0
    deep_equal(strip(lr), strip(br))
    assert bs.metrics.trace == ls.metrics.trace
    assert bs.rx_calls == ls.rx_calls
    assert sum(bs.segment_lens) == bs.num_slots
    assert ls.segment_lens == []


@pytest.fixture(scope="module")
def loop_city():
    return run_engine(True, "open_street_map_city")


@pytest.fixture(scope="module")
def block8_city():
    return run_engine(True, "open_street_map_city", block_slots=8)


def test_block8_equals_slot_loop(loop_city, block8_city):
    assert_block_equals_loop(loop_city, block8_city)
    lens = block8_city[0].segment_lens
    assert max(lens) > 1  # multi-slot segments: the D slots ahead of the U slot
    assert lens == [4, 1] * 4


def test_block8_equals_jax_slot_loop(block8_city):
    jax_sim, jax_res = run_engine(False, "open_street_map_city")
    assert_runs_equal((jax_sim, jax_res), block8_city)
    want = jax_res["sensing"]["estimates"]
    got = block8_city[1]["sensing"]["estimates"]
    for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst", "eleEst"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
