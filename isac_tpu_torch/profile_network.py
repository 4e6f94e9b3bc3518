"""Where the time of the lockstep network goes on the card.

    python3 -m isac_tpu_torch.profile_network [--frames N]

Runs example_network (multi_cell: 2 co-channel cells at 273 PRB, 16 gNB
ports, 5 UEs each, the city's line of sight, DL + UL interference) without
its sensing post-pass and prints one JSON object per line:
  - "run": per frame, on a fresh runner with the same seed after one warm-up
    frame, `network_slot_ms` (host clock of run() over the frame, after
    torch.cuda.synchronize(), per slot), `network_cell_slots_per_s`, the
    LDPC kernel's launches and the cells' sch_receive_batch calls per frame,
    the host ms per slot of each ``network.*`` stage (the runner's stage_s),
    and peak memory;
  - "profile_slots": torch.profiler over one frame, per slot: the device's
    busy share of the window, kernels launched, device ms by kernel family,
    and host / device ms of each ``network.*`` range (banks, readback,
    dl_tx, dl_cross, dl_rx, ul_tx, ul_cross, ul_rx, epilogue; set in
    sim/network.py) and of the ``cell.*``, ``pdsch.*`` and ``pusch.*``
    ranges inside them (their host ms count again there).
It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# record_function ranges of the runner, the engine and the chains inside it;
# on the device timeline they are annotations, not kernels
RANGES = ("network.", "cell.", "pdsch.", "pusch.")


def frame(runner) -> dict:
    """One frame of a fresh runner: host clock after synchronize, kernel
    launches, receive calls and the runner's host ms per slot by stage."""
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda

    torch.cuda.synchronize()
    decode_layered_cuda.launches = 0
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = runner.num_slots
    return {"network_slot_ms": secs * 1e3 / n,
            "network_cell_slots_per_s": len(runner.sims) * n / secs,
            "ldpc_launches": decode_layered_cuda.launches,
            "rx_calls": sum(s.rx_calls for s in runner.sims),
            "stage_host_ms_per_slot": {k: v * 1e3 / n for k, v in runner.stage_s.items()}}


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from isac_tpu_torch.example import example_network
    from isac_tpu_torch.profile_link_step import ranges_cost_ms, summarize_profile
    from isac_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    dev = resolve_device(None)

    def make():
        return example_network(sensing=False, device=dev)

    warm = frame(make())  # constants on the device, kernel build
    torch.cuda.reset_peak_memory_stats()
    frames = [frame(make()) for _ in range(args.frames)]
    print(json.dumps({"run": {"warm_up": warm, "frames": frames,
                              "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
                              "device": torch.cuda.get_device_name(0)}}), flush=True)

    range_ms = ranges_cost_ms("network.probe")
    runner = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary, ranges_per_slot = summarize_profile(prof, RANGES, runner.num_slots, wall_us)
    summary["ranges_cost_ms_per_step"] = range_ms * ranges_per_slot
    print(json.dumps({"profile_slots": summary}), flush=True)


if __name__ == "__main__":
    main()
