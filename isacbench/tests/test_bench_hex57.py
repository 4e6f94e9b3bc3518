"""hex57.steady: the 57-TRxP layout (19 sites x 3 sectors, the TR 38.901
element pattern at every gNB end) rehearsed on the CPU through the harness at
a cut carrier (6 PRB / nfft 128) reads correct; the two readers it adds,
``network.bank_draw_s`` and ``network.dl_term_roofline``, give None untraced
and on a program without their stage and span; the DL cross term's counts
(isacbench/dl_term_counts.py) at hex57's and hex19's shapes.

The rehearsal is one frame of 57 engines and 57 banks of 570 links, ~10 min
and ~9 GB on the CPU (most of it the 32490 link draws, the coefficients the
taps keep of them, and the banks' ray coefficients)."""

import types

import pytest
import torch

from isacbench import dl_term_counts, harness, spans

CPU = {"n_rb_override": 6, "nfft_override": 128}
SEED = 2400000057
DENSE = {"warm_slots": 2,
         "check": {"subcarriers": 24,
                   "dl_rx": {"first": 8, "within": 840, "n": 3},
                   "ul_rx": {"first": 4, "within": 228, "n": 2},
                   "ldpc": {"first": 8, "within": 1000, "n": 8},
                   "tb": {"first": 20, "within": 1000, "n": 200},
                   "rxc": {"first": 8, "within": 1000, "n": 4}}}
# (sources, ues, subcarriers, rx, tx) of one destination's DL cross term at
# 273 PRB: hex57 57 TRxPs x 10 UEs, hex19 19 cells x 10 UEs
HEX57 = (57, 10, 3276, 2, 16)
HEX19 = (19, 10, 3276, 2, 16)


def test_hex57_reads_correct():
    torch.set_num_threads(4)
    out, checks = harness.run_cell("hex57.steady", SEED, 0.1, False, device="cpu",
                                   overrides=CPU, traffic_patch=DENSE)
    assert out["correct"] is True, checks
    assert out["attempted"] == 57 * 20
    assert all(c["n"] > 0 for c in checks.values())
    assert checks["chan"]["n"] > 570  # a destination's 570 bank links are compared too


@pytest.mark.parametrize("shape, ops, nbytes", [
    (HEX57, 8 * 57 * 10 * 14 * 3276 * 2 * 16,
     8 * (57 * 10 * 14 * 3276 * 32 + 57 * 16 * 14 * 3276 + 10 * 2 * 14 * 3276)),
    (HEX19, 8 * 19 * 10 * 14 * 3276 * 2 * 16,
     8 * (19 * 10 * 14 * 3276 * 32 + 19 * 16 * 14 * 3276 + 10 * 2 * 14 * 3276)),
], ids=["hex57", "hex19"])
def test_dl_term_counts(shape, ops, nbytes):
    assert dl_term_counts.call_ops(*shape) == ops
    assert dl_term_counts.call_bytes(*shape) == nbytes
    # one complex multiply-add a response value read: the bytes bound it
    bound = dl_term_counts.call_bound_s(*shape)
    assert bound == nbytes / dl_term_counts.PEAK_BYTES_PER_S > ops / dl_term_counts.PEAK_FLOPS_FP32
    if shape == HEX57:
        assert nbytes == pytest.approx(7.037e9, rel=1e-3)  # the 6.69 GB response, the grids
        assert bound == pytest.approx(2.101e-3, rel=1e-3)


def _ctx(recs, trace=True, stage_s=None):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(window=(0, 100)) if trace else None, recs=recs,
        counters_setup={"stage_s": stage_s or {}})


def test_readers(monkeypatch):
    from isac_tpu_torch.utils.tracing import Record

    roof = harness.load_reader("network.dl_term_roofline")
    draws = harness.load_reader("network.bank_draw_s")
    attrs = dict(zip(("sources", "ues", "subcarriers", "rx", "tx"), HEX57))
    bound_ms = dl_term_counts.call_bound_s(*HEX57) * 1e3
    recs = [Record(i, None, "network.dl_term", i, i + 1, attrs=attrs, device_ms=4 * bound_ms)
            for i in (1, 3)]
    # untraced: nothing to read
    assert roof(_ctx(recs, trace=False)) is None
    assert draws(_ctx([], trace=False, stage_s={"bank_draws": 80.5})) is None
    monkeypatch.setattr(spans, "window_records", lambda ctx: ctx.recs)
    assert roof(_ctx(recs)) == pytest.approx(25.0)
    assert draws(_ctx([], stage_s={"banks": 90.0, "bank_draws": 80.5})) == 80.5
    # the parent's program: no span, no stage; never 0
    assert roof(_ctx([Record(1, None, "network.slot", 1, 2)])) is None
    assert draws(_ctx([], stage_s={"banks": 90.0})) is None
