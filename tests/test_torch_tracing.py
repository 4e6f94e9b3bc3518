"""The port's tracer (isac_tpu_torch/utils/tracing.py) and its spans.

On the CPU: off, a span keeps nothing and enters no record_function; on
(enable(), or a torch.profiler session), it enters record_function under the
same name and keeps a record with its parent and its counts; the top-level
entry's construction spans cover the time before the first engine span; the
network runner's stage spans sit in one ``network.slot`` span a slot and feed
``stage_s``.

On the card (marker ``card``; this file imports no JAX, so run it there with
``python -m pytest --noconftest tests/test_torch_tracing.py -m card -s``):
the span's clock against the profiler's device timestamps, the sync counter,
and the device time of a ``device=True`` span.
"""

import time
import warnings
from functools import partial

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from isac_tpu_torch.utils import tracing

CPU = dict(n_rb_override=12, nfft_override=256, device="cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def entered(monkeypatch):
    """Names of the record_function ranges entered, logged by patching the
    class as the benchmark's host-range log does."""
    names = []
    cls = autograd_profiler.record_function
    enter = cls.__enter__

    def logged(rf):
        names.append(rf.name)
        return enter(rf)

    monkeypatch.setattr(cls, "__enter__", logged)
    return names


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _nest():
    with tracing.span("outer", slot=3):
        time.sleep(0.004)
        with tracing.span("inner"):
            time.sleep(0.003)
            tracing.count("things", 2)
        with tracing.span("inner"):
            tracing.count("things")
        tracing.count("things", 5)


def test_off_keeps_nothing_and_enters_no_range(clean, entered):
    assert not autograd_profiler._is_profiler_enabled
    _nest()
    tracing.count("loose")
    with tracing.span("timed", timed=True) as sp:
        time.sleep(0.001)
    assert entered == [] and tracing.records() == []
    assert sp.seconds >= 0.001


def test_on_enters_the_same_names(clean, entered):
    tracing.enable()
    _nest()
    tracing.disable()
    assert entered == ["outer", "inner", "inner"]
    assert [r.name for r in tracing.records()] == ["outer", "inner", "inner"]
    # a profiler session turns recording on by itself
    tracing.reset()
    del entered[:]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _nest()
    assert entered == ["outer", "inner", "inner"]
    assert [r.name for r in tracing.records()] == ["outer", "inner", "inner"]
    assert {"outer", "inner"} <= {e.name for e in prof.events()}


def test_parents_self_time_and_counts(clean):
    tracing.enable()
    _nest()
    tracing.count("loose", 4)
    tracing.disable()
    outer, in1, in2, loose = tracing.records()
    assert outer.parent is None and in1.parent == in2.parent == outer.id
    assert outer.attrs == {"slot": 3}
    assert in1.t0 >= outer.t0 and in2.t1 <= outer.t1 and in1.t1 <= in2.t0
    recs = [outer, in1, in2]
    children = (in1.t1 - in1.t0) + (in2.t1 - in2.t0)
    assert tracing.self_ns(outer, recs) == outer.t1 - outer.t0 - children
    assert tracing.self_ns(outer, recs) >= 4e6 and tracing.self_ns(in1, recs) >= 3e6
    # counts land on the innermost open span
    assert (outer.counts, in1.counts, in2.counts) == ({"things": 5}, {"things": 2},
                                                      {"things": 1})
    assert loose.name == "count" and loose.counts == {"loose": 4} and loose.t0 == loose.t1


def test_sync_warnings_are_counted_every_time(clean):
    tracing.enable()
    with tracing.span("s"):
        for _ in range(3):
            warnings.warn(tracing.SYNC_WARNING + " (Triggered internally at c.cpp:1.)")
        with pytest.warns(UserWarning, match="another"):  # other warnings pass on
            warnings.warn("another warning")
    tracing.disable()
    (rec,) = tracing.records()
    assert rec.counts == {"sync": 3}


def test_simulate_construction_spans(clean):
    from isac_tpu_torch.api import simulate
    from isac_tpu_torch.config.scenarios import open_street_map_city

    torch.set_num_threads(2)
    tracing.enable()
    simulate(partial(open_street_map_city, seed=5), seed=5, phy_mode="passthrough", **CPU)
    tracing.disable()
    recs = tracing.records()
    build = [r for r in recs if r.parent is None and r.name.startswith("build.")]
    assert [r.name for r in build] == ["build.scenario", "build.cells", "build.los",
                                       "build.engine"]
    engine = build[-1]
    assert engine.attrs == {"cell": "cell1"}
    assert {r.name for r in recs if r.parent == engine.id} == {"build.engine.links",
                                                               "build.engine.rays"}
    first_cell = min(r.t0 for r in recs if r.name.startswith("cell."))
    covered = sum(r.t1 - r.t0 for r in build)
    assert covered >= 0.9 * (first_cell - build[0].t0)
    slots = [r for r in recs if r.name == "cell.slot"]
    assert [r.attrs["slot"] for r in slots] == list(range(20))
    assert [r.name for r in recs if r.parent is None][-2:] == ["cell.finalize",
                                                               "network.results"]


def test_runner_stage_spans_feed_stage_s(clean):
    from isac_tpu_torch.config import params, scenarios
    from isac_tpu_torch.sim.network import SyncNetworkRunner

    torch.set_num_threads(2)
    sim = scenarios.multi_cell(params.SimulationParameters(), num_cells=2)
    for name, x in (("cell1", 40.0), ("cell2", 80.0)):
        sim.ue[name] = params.UEParams(num_ues=1, position_mode="predefined",
                                       positions=np.array([[x, 5.0, 1.5]]))
    sim.validate()
    runner = SyncNetworkRunner(params.assign_cell_parameters(sim), enable_sensing=False, **CPU)
    runner.num_slots = 5  # D D D S U
    tracing.enable()
    runner.run()
    tracing.disable()
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    slots = [r for r in recs if r.name == "network.slot"]
    assert [r.attrs["slot"] for r in slots] == list(range(5))
    slot_ids = {r.id for r in slots}
    stages = [r for r in recs if r.name.startswith("network.")
              and r.name not in ("network.slot", "network.bank_h", "network.dl_term")]
    build = stages[0]  # the banks' build before the first slot
    assert build.name == "network.banks" and build.parent is None
    # each bank's link draws: a stage of their own inside the build
    draws = [r for r in stages if r.name == "network.bank_draws"]
    assert [(r.parent, r.attrs) for r in draws] == [(build.id, {"links": 2})] * 2
    for r in stages[1:]:
        if r.name == "network.bank_draws":
            continue
        parent = by_id[r.parent]
        if r.name == "network.banks":  # a slot response, inside a cross stage
            assert parent.name in ("network.dl_cross", "network.ul_cross")
            parent = by_id[parent.parent]
        assert parent.id in slot_ids, r.name
    assert {r.name for r in stages} >= {"network.readback", "network.dl_tx",
                                        "network.dl_cross", "network.dl_rx", "network.ul_tx",
                                        "network.ul_cross", "network.ul_rx", "network.epilogue"}
    assert all(by_id[r.parent].name == "network.banks"
               for r in recs if r.name == "network.bank_h")
    terms = [r for r in recs if r.name == "network.dl_term"]
    assert terms and all(by_id[r.parent].name == "network.dl_cross" for r in terms)
    for key, seconds in runner.stage_s.items():
        spans_s = sum(r.t1 - r.t0 for r in stages if r.name == f"network.{key}") / 1e9
        assert spans_s == pytest.approx(seconds, rel=1e-3), key


# ------------------------------------------------------------------ the card


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            start = ev.start_ns() if hasattr(ev, "start_ns") else int(ev.start_us() * 1000)
            dur = ev.duration_ns() if hasattr(ev, "duration_ns") else int(ev.duration_us() * 1000)
            out.append((ev.name(), start, start + dur))
    return out


@pytest.mark.card
def test_card_span_clock_matches_the_profilers(card, clean):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize()
    offsets = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.cuda.synchronize()
            with tracing.span("probe"):
                b = a @ a
            torch.cuda.synchronize()
    probes = [r for r in tracing.records() if r.name == "probe"]
    gemms = sorted((s, e) for n, s, e in _device_events(prof) if "gemm" in n.lower())
    assert len(probes) == len(gemms) == 5
    offsets = [(s - r.t0) / 1e3 for r, (s, _) in zip(probes, gemms)]
    print(f"kernel start - span start, us: {offsets}")
    assert min(offsets) >= -20.0, offsets
    del b


@pytest.mark.card
def test_card_syncs_are_counted(card, clean):
    x = torch.ones(16, device=card)
    torch.cuda.synchronize()
    tracing.enable()
    with tracing.span("s"):
        y = x * 2  # no sync
        y.sum().item()
        torch.as_tensor(np.arange(16.0), device=card)  # pageable upload
    tracing.disable()
    (rec,) = tracing.records()
    assert rec.counts == {"sync": 2}
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.card
def test_card_device_span_time(card, clean):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(4096, 4096, device=card)
    (a @ a).sum().item()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with tracing.span("mm", device=True):
            b = a @ a
        torch.cuda.synchronize()
    (rec,) = tracing.records()
    gemm = [(e - s) / 1e6 for n, s, e in _device_events(prof) if "gemm" in n.lower()]
    assert len(gemm) == 1
    print(f"device=True span {rec.device_ms} ms, kernel {gemm[0]} ms")
    assert rec.device_ms == pytest.approx(gemm[0], rel=0.2)
    del b
