"""Reduction of a torch.profiler trace of the measured window.

The arithmetic of ``isac_tpu_torch/profile_link_step.py:summarize_profile``
(kernels by family, busy share), copied here so that the yardstick does not
move with the program, with one repair: busy time is the length of the UNION
of the device's kernel and copy intervals, not the sum of their durations,
which counts twice wherever two streams overlap.

The profiler records the device only (CUDA activity): with CPU activity it
records every aten operator too, millions in a window, and reading them back
takes longer than a run may. The host side is the program's and the
harness's ``record_function`` ranges, which ``HostRanges`` logs with the same
wall clock as the profiler's timestamps while it is installed. The raw
kineto events are read (``prof.profiler.kineto_results``), not torch's
FunctionEvent tree.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

# (family, substrings of the kernel name), first match wins (profile_link_step.py)
KERNEL_FAMILIES = (
    ("ldpc_layered", ("ldpc_layered",)),
    ("fft", ("fft",)),
    ("eigh", ("syev", "heev", "jacobi", "sytrd", "hetrd", "stedc", "larf", "ormtr", "unmtr",
              "cusolver", "laed", "lasr", "steqr", "lansy", "merge_ker", "ormqr", "scale_max",
              "lacpy", "xx_set_info")),
    ("blas", ("gemm", "gemv", "gemvx", "dot_kernel", "cublas", "cutlass", "trsm", "getrf", "laswp")),
    ("pooling", ("pool",)),
    ("top_k", ("topk", "sort", "radix", "bitonic", "scanbykey")),
    ("rng", ("distribution", "philox", "normal_")),
    ("gather_copy", ("memcpy", "memset", "catarray", "roll_", "gather", "index", "copy")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "abs_kernel")),
)


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, keys in KERNEL_FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


@dataclass
class Trace:
    """Events of one traced window, times in ns on the host's clock."""

    window: tuple  # (start, end) of the harness's window span
    kernels: list = field(default_factory=list)  # (name, start, end), device kernels
    copies: list = field(default_factory=list)  # (name, start, end), device copies / sets
    ranges: list = field(default_factory=list)  # (name, start, end), host record_function
    _busy: list | None = None

    def busy(self) -> list:
        """The union of the device's kernel and copy intervals inside the
        window, merged once."""
        if self._busy is None:
            lo, hi = self.window
            self._busy = union([(s, e) for _, s, e in self.kernels + self.copies], lo, hi)
        return self._busy


class HostRanges:
    """Logs (name, start, end) of every ``record_function`` range, in ns of
    the wall clock, from ``install`` to ``uninstall``."""

    def __init__(self):
        self.ranges: list = []
        self._orig = None

    def install(self):
        from torch.autograd import profiler as autograd_profiler

        cls = autograd_profiler.record_function
        enter, leave = cls.__enter__, cls.__exit__
        self._orig = (cls, enter, leave)
        ranges = self.ranges

        def logged_enter(rf):
            rf._bench_t0 = time.time_ns()
            return enter(rf)

        def logged_exit(rf, *exc):
            out = leave(rf, *exc)
            ranges.append((rf.name, rf._bench_t0, time.time_ns()))
            return out

        cls.__enter__, cls.__exit__ = logged_enter, logged_exit

    def uninstall(self):
        if self._orig is not None:
            cls, enter, leave = self._orig
            cls.__enter__, cls.__exit__ = enter, leave
            self._orig = None


def _clock(ev) -> tuple:
    """(start, duration) readers in ns for this torch's KinetoEvent."""
    if hasattr(ev, "start_ns"):
        return (lambda e: e.start_ns()), (lambda e: e.duration_ns())
    return (lambda e: int(e.start_us() * 1000)), (lambda e: int(e.duration_us() * 1000))


def collect(prof, host: HostRanges, window_name: str = "bench.window") -> Trace:
    """The device's kernels and copies of a finished profiler run (None: no
    device traced) and the logged host ranges; the window is the host range
    named `window_name`. Device events named like a host range are the
    profiler's echo of that range on the device's timeline, not work."""
    import torch

    ranges = sorted(host.ranges, key=lambda r: r[1])
    names = {r[0] for r in ranges}
    kernels, copies = [], []
    events = prof.profiler.kineto_results.events() if prof is not None else []
    cuda = torch.autograd.DeviceType.CUDA
    if events:
        start_of, length_of = _clock(events[0])
    for ev in events:
        if ev.device_type() != cuda:
            continue
        name = ev.name()
        if name in names:
            continue
        start = start_of(ev)
        item = (name, start, start + length_of(ev))
        (copies if name[:6].lower() in ("memcpy", "memset") else kernels).append(item)
    windows = [(s, e) for name, s, e in ranges if name == window_name]
    if not windows:
        raise RuntimeError(f"no {window_name!r} range was logged")
    kernels.sort(key=lambda k: k[1])
    copies.sort(key=lambda k: k[1])
    return Trace(windows[-1], kernels, copies, ranges)


def union(intervals, lo: int | None = None, hi: int | None = None) -> list:
    """Merged [start, end] intervals, clipped to [lo, hi]."""
    out: list = []
    for s, e in sorted((s, e) for s, e in intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(tr: Trace) -> int:
    """Nanoseconds of the window in which a kernel or copy ran on the device."""
    return sum(e - s for s, e in tr.busy())


def idle_gaps(tr: Trace) -> list:
    """[(start, end)] of the window's stretches with nothing on the device."""
    lo, hi = tr.window
    gaps, t = [], lo
    for s, e in tr.busy():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def innermost_ranges(ranges: list, points: list) -> list:
    """For each of the sorted `points`, the name of the innermost host range
    open at it ('(none)' outside every range). Ranges nest on one thread, so
    the top of a stack of open ranges is the innermost."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ranges) and ranges[i][1] <= p:
            while stack and stack[-1][2] < ranges[i][1]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out.append(stack[-1][0] if stack else "(none)")
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each a list of [name, seconds], at most `top` long."""
    lo, hi = tr.window
    ops: dict = {}
    for name, s, e in tr.kernels + tr.copies:
        if s >= lo and e <= hi:
            ops[name[:90]] = ops.get(name[:90], 0) + (e - s)
    gaps = idle_gaps(tr)
    names = innermost_ranges(tr.ranges, [(s + e) // 2 for s, e in gaps])
    idle: dict = {}
    for (s, e), name in zip(gaps, names):
        idle[name] = idle.get(name, 0) + (e - s)
    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def families(tr: Trace) -> dict:
    """Device seconds and launches by kernel family inside the window."""
    lo, hi = tr.window
    out: dict = {}
    for name, s, e in tr.kernels:
        if s >= lo and e <= hi:
            t, n = out.get(kernel_family(name), (0, 0))
            out[kernel_family(name)] = (t + e - s, n + 1)
    return {k: {"s": t / 1e9, "launches": n} for k, (t, n) in out.items()}


def ranges_named(tr: Trace, prefix: str) -> list:
    """Host ranges whose name starts with `prefix`, inside the window."""
    lo, hi = tr.window
    return [r for r in tr.ranges if r[0].startswith(prefix) and r[1] >= lo and r[2] <= hi]
