"""Where the time of the per-cell engine goes on the card.

    python3 -m isac_tpu_torch.profile_cell [--frames N] [--block-slots K]

Runs the engine on the shipped scenario (example_cell: open_street_map_city,
273 PRB, 16 gNB ports, 5 UEs, one target, one frame of 20 slots) and prints
one JSON object per line:
  - "run": per frame, on a fresh simulator with the same seed after one
    warm-up frame, `cell_slot_ms` (host clock of run(finalize=False) over the
    frame's slots, after torch.cuda.synchronize(), per slot),
    `cell_sensing_ms` (run_sensing, host clock), the LDPC kernel's launches
    and the engine's sch_receive_batch calls per frame, and peak memory;
  - "profile_slots": torch.profiler over one frame's slot loop, per slot: the
    device's busy share of the window, kernels launched, device ms by kernel
    family, and host / device ms of each ``cell.*`` range (tick, plan,
    dl_tx, dl_rx, ul_tx, ul_rx, csi, srs, due_readback; set in sim/cell.py);
  - "profile_finalize": the same over finalize() (last due results, KPIs and
    the sensing post-pass, range ``cell.sensing``).
--block-slots K runs every frame in block mode with segments of at most K
slots (sim/block.py; each segment's device work is one ``cell.segment``
range); 0, the default, runs the slot loop.
The ``cell.*`` ranges hold the chains' own (``pdsch.*``, ``pusch.*``,
``sensing.*``), which are listed beside them (their host ms count twice
there) and kept out of the kernel counts. It needs a CUDA card and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# record_function ranges of the engine and of the chains inside it; on the
# device timeline they are annotations, not kernels
RANGES = ("cell.", "pdsch.", "pusch.", "sensing.")


def _frame(make, n_slots: int) -> dict:
    """One frame on a fresh simulator: slot-loop and sensing times (host clock
    after synchronize), kernel launches and receive calls."""
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda

    sim = make()
    torch.cuda.synchronize()
    decode_layered_cuda.launches = 0
    t0 = time.perf_counter()
    sim.run(finalize=False)
    torch.cuda.synchronize()
    slot_ms = (time.perf_counter() - t0) * 1e3 / n_slots
    launches = decode_layered_cuda.launches
    sim.finalize(sensing=False)  # last due results + KPIs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_sensing()
    torch.cuda.synchronize()
    return {"cell_slot_ms": slot_ms, "cell_sensing_ms": (time.perf_counter() - t0) * 1e3,
            "ldpc_launches": launches, "rx_calls": sim.rx_calls}


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from isac_tpu_torch.example import example_cell
    from isac_tpu_torch.profile_link_step import ranges_cost_ms, summarize_profile
    from isac_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--block-slots", type=int, default=0)
    args = ap.parse_args()
    dev = resolve_device(None)

    def make():
        return example_cell(device=dev, block_slots=args.block_slots)

    n_slots = make().num_slots
    warm = _frame(make, n_slots)  # constants on the device, FFT plans, kernel build
    torch.cuda.reset_peak_memory_stats()
    frames = [_frame(make, n_slots) for _ in range(args.frames)]
    print(json.dumps({"run": {"warm_up": warm, "frames": frames,
                              "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
                              "device": torch.cuda.get_device_name(0)}}), flush=True)

    range_ms = ranges_cost_ms("cell.probe")
    sim = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(finalize=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary, ranges_per_slot = summarize_profile(prof, RANGES, n_slots, wall_us)
    summary["ranges_cost_ms_per_step"] = range_ms * ranges_per_slot
    print(json.dumps({"profile_slots": summary}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.finalize()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary, _ = summarize_profile(prof, RANGES, 1, wall_us)
    print(json.dumps({"profile_finalize": summary}), flush=True)


if __name__ == "__main__":
    main()
