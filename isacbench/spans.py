"""The program's own spans and counts (``isac_tpu_torch/utils/tracing.py``)
that lie inside the traced window, for the readers in ``metrics/``.

The tracer records while the harness's profiler runs; its clock is the one
``trace.HostRanges`` stamps the window with. A program without the tracer, an
untraced run, or a window in which it kept nothing gives None, never an
error.
"""

from __future__ import annotations


def window_records(ctx) -> list | None:
    if ctx.trace is None:
        return None
    try:
        from isac_tpu_torch.utils import tracing
    except ImportError:
        return None
    lo, hi = ctx.trace.window
    recs = [r for r in tracing.records() if r.t0 >= lo and r.t1 <= hi]
    return recs or None


def named(recs: list, *names: str) -> list:
    return [r for r in recs if r.name in names]


def host_ms(recs: list) -> float:
    return sum(r.t1 - r.t0 for r in recs) / 1e6


def device_ms(recs: list) -> list:
    """The device ms of the records that have one (``device=True`` spans on
    the card)."""
    return [r.device_ms for r in recs if r.device_ms is not None]
