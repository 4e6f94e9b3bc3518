"""The port's tracer: named spans and counts on the wall clock.

Every range the port opens is a ``span``. Recording is on while a
torch.profiler session is active, or between ``enable()`` and ``disable()``:

- Off, a span checks that and does nothing else: it enters no
  ``record_function`` and keeps nothing. A span opened with ``timed=True``
  also reads the clock, for a caller that keeps its own totals
  (``SyncNetworkRunner.stage_s``).
- On, a span enters ``torch.profiler.record_function(name)``, so the
  profiler and every reader of its ranges see the same names, and keeps a
  ``Record``: its start and end in ns of ``time.time_ns()`` (the clock the
  profiler converts its device timestamps to), its parent, its attributes and
  the counts made while it was the innermost open span. A span opened with
  ``device=True`` also records a CUDA event pair on the current stream;
  ``records()`` reads the pair's elapsed time, never the span.

While recording is on, every synchronising CUDA operation (a pageable upload,
a readback, ``.item()``) counts as ``sync`` in the innermost open span: the
tracer sets ``torch.cuda.set_sync_debug_mode("warn")`` on an initialised CUDA
context and takes each of its warnings, every occurrence, without printing
it. The previous mode comes back when recording stops. Nothing is written to
a file; readers take ``records()`` in memory.
"""

from __future__ import annotations

import itertools
import threading
import time
import warnings
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclass(eq=False)
class Record:
    """One closed span. `t0`, `t1`: ns of ``time.time_ns()``; `parent`: the
    id of the span open around it on its thread (None at the top);
    `counts`: name -> total of the counts made while it was innermost;
    `device_ms`: the elapsed time of its CUDA event pair (``device=True``
    spans on the card), read by ``records()``."""

    id: int
    parent: int | None
    name: str
    t0: int
    t1: int = 0
    attrs: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    device_ms: float | None = None


class _Tracer:
    """The process's recording state: its records, each thread's stack of
    open spans, and the sync counter while it is installed."""

    def __init__(self):
        self.forced = False  # enable() .. disable()
        self.live = False  # forced, or the sync counter installed: spans look closer
        self.records: list = []
        self.pending: list = []  # (record, start event, end event)
        self.ids = itertools.count(1)
        self.local = threading.local()
        self._warnings = None
        self._sync_mode = None

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def recording(self) -> bool:
        """On: a profiler session or enable(). Installs the sync counter when
        recording starts and removes it when recording has stopped."""
        on = _autograd_profiler._is_profiler_enabled or self.forced
        if on and self._warnings is None:
            self._install()
        elif not on and self._warnings is not None:
            self._uninstall()
        self.live = self.forced or self._warnings is not None
        return on

    def _install(self):
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        passed_on = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                count("sync")
            else:
                passed_on(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        # torch says once that the mode is a prototype; standard error is the
        # caller's, and the tracer prints nothing there
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        if torch.cuda.is_initialized():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def _uninstall(self):
        if self._sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None
        self._warnings.__exit__(None, None, None)
        self._warnings = None


_T = _Tracer()


class span:
    """``with span(name, **attrs):`` one named range of the port. See the
    module's docstring for what it costs and keeps. `device`: also time the
    device work enqueued inside it with a CUDA event pair. `timed`: keep the
    host duration in `seconds` whether or not recording is on."""

    __slots__ = ("name", "attrs", "device", "timed", "t0", "t1", "_rec", "_rf", "_ev")

    def __init__(self, name: str, device: bool = False, timed: bool = False, **attrs):
        self.name = name
        self.attrs = attrs
        self.device = device
        self.timed = timed
        self._rec = None

    def __enter__(self):
        if (_autograd_profiler._is_profiler_enabled or _T.live) and _T.recording():
            self._open()
        elif self.timed:
            self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        if rec is None:
            if self.timed:
                self.t1 = time.time_ns()
            return False
        t1 = time.time_ns()
        if self._ev is not None:
            self._ev[1].record()
            _T.pending.append((rec, *self._ev))
        _T.stack().pop()
        self._rf.__exit__(exc_type, exc, tb)
        rec.t1 = self.t1 = t1
        _T.records.append(rec)
        self._rec = None
        return False

    def _open(self):
        stack = _T.stack()
        self._rec = Record(next(_T.ids), stack[-1].id if stack else None, self.name, 0,
                           attrs=self.attrs)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._ev = None
        if self.device and torch.cuda.is_initialized():
            self._ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        stack.append(self._rec)
        self._rec.t0 = self.t0 = time.time_ns()

    @property
    def seconds(self) -> float:
        """Host seconds from enter to exit (a closed span that was recorded
        or `timed`)."""
        return (self.t1 - self.t0) / 1e9


def count(name: str, n: int = 1):
    """Add `n` to `name` in the innermost open span of this thread. With no
    span open, the count is kept in a record of its own, named ``count``,
    that starts and ends when it was made. Nothing while recording is off."""
    if not ((_autograd_profiler._is_profiler_enabled or _T.live) and _T.recording()):
        return
    stack = _T.stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
    else:
        t = time.time_ns()
        _T.records.append(Record(next(_T.ids), None, "count", t, t, counts={name: n}))


def enable():
    """Record without a profiler session, until disable()."""
    _T.forced = True
    _T.recording()


def disable():
    _T.forced = False
    _T.recording()


def records() -> list:
    """Every closed span and loose count since the last reset(), by start
    time. Waits for the end events of ``device=True`` spans to read their
    device time."""
    _T.recording()
    while _T.pending:
        rec, start, end = _T.pending.pop()
        end.synchronize()
        rec.device_ms = start.elapsed_time(end)
    return sorted(_T.records, key=lambda r: (r.t0, r.id))


def reset():
    """Forget every record (spans still open are kept when they close)."""
    _T.records.clear()
    _T.pending.clear()


def self_ns(rec: Record, recs: list) -> int:
    """`rec`'s duration less the part of it that its child spans cover."""
    children = [(r.t0, r.t1) for r in recs if r.parent == rec.id]
    covered, end = 0, rec.t0
    for t0, t1 in sorted(children):
        t0, t1 = max(t0, end), min(t1, rec.t1)
        if t1 > t0:
            covered += t1 - t0
            end = t1
    return rec.t1 - rec.t0 - covered
