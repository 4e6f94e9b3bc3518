"""Where the time of the mono-static sensing chain goes on the card.

    python3 -m isac_tpu_torch.profile_sensing

Profiles the real chain of ``make_sensing_chain`` at the reference benchmark's
sensing inputs (``example_sensing``: 273 PRB, 16 antennas, 20 slots, FFT
algorithm, MUSIC DoA) over 4 runs with distinct noise, and prints one JSON
object per line:
  - "run": ms per run by CUDA events and by the host clock, unprofiled, the
    peak device memory of the runs and what was resident before them;
  - "ranges_cost": what the chain's record_function stage ranges cost on the
    host with no profiler running (ms per range and per run);
  - "profile": torch.profiler over the same runs: the device's busy share of
    the window, kernels launched per run, the kernels that take the most
    device time, and per stage range (``sensing.*``, set in sim/sensing.py and
    ops/sensing/__init__.py) its host ms and device ms per run (the keys say
    "per_step", the link step's word: a step here is one run of the chain).
It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import json
import time

import torch

N_RUNS = 4
RANGE_PREFIX = "sensing."


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from isac_tpu_torch.example import example_sensing
    from isac_tpu_torch.profile_link_step import ranges_cost_ms, summarize_profile
    from isac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    chain, params, grids = example_sensing(num_slots=20, seed=0, device=dev)
    gens = []
    for i in range(N_RUNS):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + i)
        gens.append(g)
    chain(grids, gens[0])  # warm-up: FFT plans, constants on the device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_mb = torch.cuda.memory_allocated() / 2**20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    n_det = [chain(grids, g)["valid"].sum() for g in gens]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / N_RUNS * 1e3
    if [int(n) for n in n_det] != [1] * N_RUNS:
        raise AssertionError(f"detections per run {[int(n) for n in n_det]}, expected one each")
    print(json.dumps({"run": {"event_ms": start.elapsed_time(end) / N_RUNS, "host_ms": host_ms,
                              "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
                              "resident_before_mb": resident_mb,
                              "n_ifft": params.n_ifft, "n_fft": params.n_fft,
                              "grid": list(grids[0].shape),
                              "device": torch.cuda.get_device_name(0)}}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for g in gens:
            chain(grids, g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary, ranges_per_run = summarize_profile(prof, RANGE_PREFIX, N_RUNS, wall_us)
    range_ms = ranges_cost_ms("sensing.probe")
    print(json.dumps({"ranges_cost": {"ms_per_range": range_ms, "ranges_per_run": ranges_per_run,
                                      "ms_per_run": range_ms * ranges_per_run}}), flush=True)
    print(json.dumps({"profile": summary}), flush=True)


if __name__ == "__main__":
    main()
