"""One run of one cell: set-up, the measured window, the trace's reduction,
the comparison with the plain reference, and the result line.

``run.py`` calls ``run_cell`` on the card. The CPU rehearsal (the tests in
``isacbench/tests``) calls it with ``device="cpu"`` and engine overrides that
cut the carrier; it never stands for a measurement.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.profiler import record_function

from isacbench import capture, trace

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "isac_tpu")


def load_spec(path: Path | None = None) -> dict:
    return json.loads((path or CHECKOUT / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_reader(metric: str):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"isacbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info() -> dict:
    """Name and power limit of the first card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        name, limit = out.strip().splitlines()[0].split(", ")
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as exc:
        return {"name": torch.cuda.get_device_name(0), "power_limit": f"unread ({exc})"}


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    workload: str
    cell_slots: int
    counters_setup: dict
    counters_window: dict
    launches: list
    trace: trace.Trace | None = None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             overrides: dict | None = None, t0: float | None = None, spec: dict | None = None,
             traffic_patch: dict | None = None, controls: bool = False) -> tuple:
    """Run one cell once. Returns (result line as a dict, the compared
    numbers as a dict name -> {value, limit, n}).

    The CPU rehearsal passes `overrides` (engine keyword arguments that cut
    the carrier) and `traffic_patch` (keys replaced in the traffic file, such
    as fewer frames or a denser sample). `controls` adds
    the control's readings of the same run under "control" (isacbench/
    control.py)."""
    from isacbench.reference import check

    t0 = time.perf_counter() if t0 is None else t0
    spec = spec or load_spec()
    cell = find(spec["workloads"], workload, "workload")
    config = load_json("configs", cell["config"])
    traffic = {**load_json("traffic", cell["traffic"]), **(traffic_patch or {})}
    kind = importlib.import_module(f"isacbench.kinds.{traffic['kind']}")
    on_card = torch.device(device).type == "cuda"
    card = card_info() if on_card else {"name": "cpu", "power_limit": "n/a"}

    cap = capture.Capture(seed, traffic["check"])
    cap.install()
    try:
        state = kind.setup(config, traffic, seed, device, dict(overrides or {}))
        counters_setup = state.counters()
        _sync(device)
        setup_s = time.perf_counter() - t0

        prof = host = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            host = trace.HostRanges()
            host.install()
            if on_card:
                prof = profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                               with_stack=False, profile_memory=False)
                prof.__enter__()
        cap.enabled = True
        w0 = time.perf_counter()
        with record_function("bench.window"):
            units, cell_slots = kind.window(state, seconds)
            _sync(device)
        window_s = time.perf_counter() - w0
        cap.enabled = False
        t_read = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        if host is not None:
            host.uninstall()
        counters_window = state.counters()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        cap.uninstall()
        if host is not None:
            host.uninstall()

    tr = trace.collect(prof, host) if traced else None
    trace_s = time.perf_counter() - t_read
    kind.release(state)
    del state
    t_check = time.perf_counter()

    numbers = check.evaluate(cap, traffic["check"], device)
    control = check.evaluate(cap, traffic["check"], device, control=True) if controls else None
    launches = list(cap.launches)
    del cap
    checks = check.judge(numbers)
    check_s = time.perf_counter() - t_check
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    out = {"correct": correct, "attempted": cell_slots, "failed": 0}
    if traced:
        ctx = Context(workload, cell_slots, counters_setup, counters_window, launches, tr)
        metrics = {}
        for m in spec["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
    else:
        values = {"cell_slots_per_s": cell_slots / window_s, "peak_mem_gib": peak / 2**30,
                  "setup_s": setup_s}
        out["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])
        }
    out["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": int(peak),
    }
    if traced:
        if on_card:
            out["device"]["busy_s"] = trace.busy_ns(tr) / 1e9
            out["device"]["window_s"] = (tr.window[1] - tr.window[0]) / 1e9
            out["breakdown"] = trace.breakdown(tr)
            out["families"] = trace.families(tr)
        else:
            out["device"]["busy_s"] = 0.0
            out["device"]["window_s"] = window_s
    out["card"] = card
    out["run"] = {"units": units, "cell_slots": cell_slots, "window_s": window_s,
                  "setup_s": setup_s, "trace_read_s": trace_s, "check_s": check_s, "seed": seed}
    if control is not None:
        out["control"] = {name: {"value": v, "n": n} for name, (v, n) in sorted(control.items())}
    out["checks"] = checks
    return out, checks
