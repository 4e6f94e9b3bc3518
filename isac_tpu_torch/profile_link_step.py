"""Where the time of the batched PDSCH link step goes on the card.

    python3 -m isac_tpu_torch.profile_link_step

Profiles the real ``make_link_step`` at bench_pdsch's configuration (273 PRB,
4 links, MCS 19, 2 layers, 16 tx / 2 rx) over 4 steps with distinct TB bits,
and prints one JSON object per line:
  - "step": ms per step by CUDA events and by the host clock, unprofiled;
  - "ranges_cost": what the step's record_function stage ranges cost on the
    host with no profiler running (ms per range and per step);
  - "profile": torch.profiler over the same steps: the device's busy share of
    the window, kernels launched per step, the kernels that take the most
    device time, and per stage range (``pdsch.*``, set in phy/chains.py and
    parallel/links.py) its host ms and device ms per step.
It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import json
import time

import torch

N_STEPS = 4
RANGE_PREFIX = "pdsch."


def ranges_cost_ms(name: str = "pdsch.probe", n: int = 20000) -> float:
    """Host ms of one empty record_function range with no profiler running."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    for _ in range(n):
        with record_function(name):
            pass
    return (time.perf_counter() - t0) / n * 1e3


# (family, substrings of the kernel name), first match wins
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


def summarize_profile(prof, range_prefix, n_steps: int, wall_us: float):
    """(profile dict, ranges per step) of a torch.profiler run over `n_steps`
    steps that took `wall_us` on the host: the device's busy share of the
    window, kernels launched per step, device ms and launches per step by
    kernel family (`kernel_family`), the 15 kernels with the most device
    time, and per `record_function` range whose name starts with
    `range_prefix` (a string or a tuple of them) its host ms and device ms
    (first to last kernel) per step."""
    kern, ranges, families = {}, {}, {}
    n_ranges = 0
    for ev in prof.events():
        us = ev.time_range.elapsed_us()
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.name.startswith(range_prefix):
            host, device = ranges.get(ev.name, (0.0, 0.0))
            ranges[ev.name] = (host, device + us) if on_device else (host + us, device)
            n_ranges += not on_device
        elif on_device:
            t, n = kern.get(ev.name[:90], (0.0, 0))
            kern[ev.name[:90]] = (t + us, n + 1)
            t, n = families.get(kernel_family(ev.name), (0.0, 0))
            families[kernel_family(ev.name)] = (t + us, n + 1)
    busy_us = sum(t for t, _ in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "window_ms_per_step": wall_us / n_steps / 1e3,
        "device_busy_ms_per_step": busy_us / n_steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernels_per_step": sum(n for _, n in kern.values()) / n_steps,
        "families": {k: {"ms_per_step": t / n_steps / 1e3, "calls_per_step": n / n_steps}
                     for k, (t, n) in sorted(families.items(), key=lambda kv: -kv[1][0])},
        "other_kernels": sorted(k for k in kern if kernel_family(k) == "other")[:12],
        "stages": {k: {"host_ms_per_step": hu / n_steps / 1e3,
                       "device_ms_per_step": du / n_steps / 1e3}
                   for k, (hu, du) in ranges.items()},
        "top": [{"kernel": k, "ms_per_step": t / n_steps / 1e3, "calls_per_step": n / n_steps}
                for k, (t, n) in top],
    }, n_ranges / n_steps


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from isac_tpu_torch.example import example_link_batch
    from isac_tpu_torch.parallel.links import make_link_step
    from isac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    g, (tb, w, h, noise), tbs = example_link_batch(n_prb=273, n_links=4, mcs=19, n_layers=2,
                                                   device=dev)
    step, _ = make_link_step(g, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    tbs_in = [torch.randint(0, 2, tb.shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(N_STEPS)]
    step(tbs_in[0], w, h, noise)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = [step(x, w, h, noise) for x in tbs_in]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / N_STEPS * 1e3
    if not all(bool(o["crc_ok"].all()) for o in outs):
        raise AssertionError("a transport block failed its CRC in the profiled step")
    print(json.dumps({"step": {"event_ms": start.elapsed_time(end) / N_STEPS,
                               "host_ms": host_ms, "tbs": tbs, "n_prb": 273, "links": 4,
                               "device": torch.cuda.get_device_name(0)}}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in tbs_in:
            step(x, w, h, noise)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary, ranges_per_step = summarize_profile(prof, RANGE_PREFIX, N_STEPS, wall_us)
    range_ms = ranges_cost_ms()
    print(json.dumps({"ranges_cost": {"ms_per_range": range_ms,
                                      "ranges_per_step": ranges_per_step,
                                      "ms_per_step": range_ms * ranges_per_step}}),
          flush=True)
    print(json.dumps({"profile": summary}), flush=True)


if __name__ == "__main__":
    main()
