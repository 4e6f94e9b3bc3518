"""The readers of the program's own spans and counts (isacbench/spans.py and
the metrics that use it) on spans recorded here: each reads what lies inside
the window, and None outside it, untraced, or from a program without the
tracer."""

import sys
import time

import pytest

from isacbench import harness, trace
from isac_tpu_torch.utils import tracing

NEW = ("build.topology_ms", "build.engine_ms", "engine.syncs_per_cell_slot",
       "network.bank_device_ms_per_slot", "sensing.noise_device_ms")


def _ctx(window, cell_slots=20):
    tr = None if window is None else trace.Trace(window=window)
    return harness.Context("osm-cell.drops", cell_slots, {}, {}, [], tr)


@pytest.fixture
def recorded():
    tracing.reset()
    tracing.enable()
    lo = time.time_ns()
    try:
        for _ in range(2):  # two drops
            with tracing.span("build.scenario"):
                time.sleep(0.002)
            with tracing.span("build.cells"):
                pass
            with tracing.span("build.los"):
                time.sleep(0.001)
            with tracing.span("build.engine", cell="cell1"):
                with tracing.span("build.engine.links"):
                    time.sleep(0.001)
            with tracing.span("sensing.noise", device=True):
                tracing.count("sync")
        for slot in range(4):
            with tracing.span("network.slot", slot=slot):
                with tracing.span("network.bank_h", device=True):
                    tracing.count("sync", 2)
        hi = time.time_ns()
    finally:
        tracing.disable()
    recs = tracing.records()
    for r in recs:  # no card here: stand in for the event pairs' readings
        if r.name in ("network.bank_h", "sensing.noise"):
            r.device_ms = 3.0
    yield recs, (lo, hi)
    tracing.reset()


def test_readers_read_the_window(recorded):
    recs, window = recorded
    ctx = _ctx(window)

    def ms(*names):
        return sum(r.t1 - r.t0 for r in recs if r.name in names) / 1e6

    read = {m: harness.load_reader(m) for m in NEW}
    assert read["build.topology_ms"](ctx) == pytest.approx(
        ms("build.scenario", "build.cells", "build.los") / 2)
    assert read["build.engine_ms"](ctx) == pytest.approx(ms("build.engine") / 2)
    assert read["build.engine_ms"](ctx) > ms("build.engine.links") / 2
    assert read["engine.syncs_per_cell_slot"](ctx) == (2 + 8) / 20
    assert read["network.bank_device_ms_per_slot"](ctx) == 3.0
    assert read["sensing.noise_device_ms"](ctx) == 3.0


def test_readers_read_nothing_outside_the_window(recorded, monkeypatch):
    _, (lo, hi) = recorded
    for ctx in (_ctx((hi + 1, hi + 2)), _ctx(None), _ctx((lo, hi), cell_slots=0)):
        for m in NEW:
            if m == "engine.syncs_per_cell_slot" or ctx.cell_slots:
                assert harness.load_reader(m)(ctx) is None, m
    import isac_tpu_torch.utils

    # a program without the tracer
    monkeypatch.delattr(isac_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "isac_tpu_torch.utils.tracing", None)
    for m in NEW:
        assert harness.load_reader(m)(_ctx((lo, hi))) is None, m
