"""The network banks' operation and byte counts (isacbench/bank_counts.py)
at hex7's and hex19's shapes, and the roofline reader on spans."""

import types

import pytest

from isacbench import bank_counts

# (links, subcarriers, delays, rays, ports) of one destination's whole slot
# response at 273 PRB: hex7 is 7 cells x 5 UEs, hex19 19 cells x 10 UEs;
# CDL-A gives 23 delays and 460 rays, the gNB 16 ports and a UE 2
HEX7 = (35, 3276, 23, 460, 32)
HEX19 = (190, 3276, 23, 460, 32)


@pytest.mark.parametrize("shape, ops, nbytes", [
    (HEX7, 8 * 35 * 3276 * 23 * 14 * 32 + 8 * 35 * 14 * 460 * 32,
     8 * (35 * 14 * 3276 * 32 + 35 * 3276 * 23 + 35 * 23 * 14 * 32)),
    (HEX19, 8 * 190 * 3276 * 23 * 14 * 32 + 8 * 190 * 14 * 460 * 32,
     8 * (190 * 14 * 3276 * 32 + 190 * 3276 * 23 + 190 * 23 * 14 * 32)),
], ids=["hex7", "hex19"])
def test_counts_at_the_cells_shapes(shape, ops, nbytes):
    L, K, N, R, P = shape
    assert bank_counts.call_ops(L, K, N, R, P) == ops
    assert bank_counts.call_bytes(L, K, N, P) == nbytes
    # the contraction's operations edge out the 2.23 GB written at hex19:
    # 0.770 ms against 0.705 ms
    bound = bank_counts.call_bound_s(L, K, N, R, P)
    mem = nbytes / bank_counts.PEAK_BYTES_PER_S
    assert bound == ops / bank_counts.PEAK_FLOPS_FP32 > mem > 0.9 * bound
    if L == 190:
        assert bound == pytest.approx(0.770e-3, rel=1e-3)
        assert mem == pytest.approx(0.705e-3, rel=1e-3)


def test_counts_scale_with_links():
    L, K, N, R, P = HEX19
    assert bank_counts.call_ops(10, K, N, R, P) * 19 == bank_counts.call_ops(L, K, N, R, P)
    assert bank_counts.call_bytes(10, K, N, P) * 19 == bank_counts.call_bytes(L, K, N, P)


def _ctx(recs):
    return types.SimpleNamespace(trace=types.SimpleNamespace(window=(0, 100)), recs=recs)


def test_roofline_reader(monkeypatch):
    from isac_tpu_torch.utils.tracing import Record
    from isacbench import harness, spans

    read = harness.load_reader("network.bank_h_roofline")
    L, K, N, R, P = HEX19
    attrs = dict(links=L, subcarriers=K, delays=N, rays=R, ports=P)
    bound_ms = bank_counts.call_bound_s(L, K, N, R, P) * 1e3
    recs = [Record(1, None, "network.bank_h", 1, 2, attrs=attrs, device_ms=2 * bound_ms),
            Record(2, None, "network.bank_h", 3, 4, attrs=attrs, device_ms=2 * bound_ms)]
    monkeypatch.setattr(spans, "window_records", lambda ctx: ctx.recs)
    assert read(_ctx(recs)) == pytest.approx(50.0)
    # the parent's spans carry no attributes: nothing to read, never 0
    bare = [Record(1, None, "network.bank_h", 1, 2, device_ms=1.0)]
    assert read(_ctx(bare)) is None
    assert read(_ctx([Record(1, None, "network.slot", 1, 2)])) is None


def test_bank_gib_reader(monkeypatch):
    from isac_tpu_torch.utils.tracing import Record
    from isacbench import harness, spans

    read = harness.load_reader("network.bank_gib")
    monkeypatch.setattr(spans, "window_records", lambda ctx: ctx.recs)
    recs = [Record(i, None, "network.slot", i, i, counts={"network.bank_bytes": b})
            for i, b in enumerate([2**30, 3 * 2**30, 3 * 2**30], start=1)]
    assert read(_ctx(recs)) == 3.0
    assert read(_ctx([Record(1, None, "network.slot", 1, 2)])) is None
