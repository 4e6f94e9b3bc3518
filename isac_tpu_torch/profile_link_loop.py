"""Where the time of the link loop goes on the card.

    python3 -m isac_tpu_torch.profile_link_loop

Profiles the real loop of ``example_link_loop`` at full width (273 PRB, 16 gNB
ports, 4 two-antenna UEs on 68 PRBs each) and prints one JSON object per line:
  - "run": per phase of the loop (csi_report, dl_slot, srs_report, ul_slot)
    its ms per call by CUDA events and by the host clock, unprofiled, over
    N_ROUNDS calls, the LDPC kernel's launches per call, the CRC outcomes by
    rv, and the peak device memory;
  - "flooding": sch_decode of one DL slot's LLRs with the flooding schedule at
    2 x n_iter against the layered kernel at n_iter, with the early exit (one
    device-to-host read per iteration) and with it off;
  - "profile_<phase>": torch.profiler over the same calls of that phase: the
    device's busy share of the window, kernels launched per call, the kernels
    that take the most device time, and per stage range (``csi.*``, ``srs.*``,
    ``pdsch.*``, ``pusch.*``; set in example.py and phy/chains.py) its host
    ms and device ms per call (the keys say "per_step": a step here is one
    call of the phase).
It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

N_ROUNDS = 8
RANGE_PREFIXES = ("csi.", "srs.", "pdsch.", "pusch.")


def _timed(fn, n: int):
    """(event ms per call, host ms per call, results) of n calls of fn()."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = [fn() for _ in range(n)]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, (time.perf_counter() - t0) / n * 1e3, out


def flooding_cost(loop, dev) -> dict:
    """Flooding at 2 x n_iter against the layered kernel at n_iter on noisy
    LLRs of one 68-PRB DL grant per UE (same code blocks for both)."""
    from isac_tpu_torch.ops import transport
    from isac_tpu_torch.phy.chains import SCHGrant, _layout

    g = SCHGrant(n_prb=loop.n_prb // loop.n_ues, mcs=15, n_layers=2, n_sc_grid=loop.n_sc)
    cfg = _layout(g.layout_key())["cfg"]
    rng = np.random.default_rng(0)
    tb = torch.as_tensor(rng.integers(0, 2, (loop.n_ues, cfg.a)).astype(np.int8), device=dev)
    enc = transport.sch_encode(tb, cfg, 0).to(torch.float32)
    sigma = 0.45
    noise = torch.as_tensor(rng.standard_normal(tuple(enc.shape)).astype(np.float32), device=dev)
    llr = 2.0 * ((1.0 - 2.0 * enc) + sigma * noise) / sigma**2
    res = {"code_blocks": cfg.c * loop.n_ues, "bg": cfg.bg, "z": cfg.z}
    for name, kw in (("layered_kernel_6", dict(n_iter=6)),
                     ("flooding_12_early_exit", dict(n_iter=12, schedule="flooding"))):
        transport.sch_decode(llr, cfg, 0, **kw)
        ms, host_ms, outs = _timed(lambda: transport.sch_decode(llr, cfg, 0, **kw), 4)
        res[name] = {"event_ms": ms, "host_ms": host_ms,
                     "tb_ok": outs[-1][1].tolist(),
                     "tb_equal": bool(torch.equal(outs[-1][0], tb))}
    return res


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from isac_tpu_torch.example import example_link_loop
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda
    from isac_tpu_torch.profile_link_step import ranges_cost_ms, summarize_profile
    from isac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    loop = example_link_loop(device=dev)
    rng = np.random.default_rng(1)

    def phase(name):
        """fn() = the next call of the loop's method `name`, on noise drawn
        here, before the timed or profiled window."""
        noises = iter([loop.draw_noise(rng, name) for _ in range(N_ROUNDS)])
        return lambda: getattr(loop, name)(rng, noise=next(noises))

    phases = ("csi_report", "dl_slot", "srs_report", "ul_slot")
    for name in phases:  # warm-up: constants on the device, FFT plans, kernel build
        getattr(loop, name)(rng)
    torch.cuda.reset_peak_memory_stats()
    run = {}
    for name in phases:
        fn = phase(name)
        decode_layered_cuda.launches = 0
        ms, host_ms, outs = _timed(fn, N_ROUNDS)
        run[name] = {"event_ms": ms, "host_ms": host_ms,
                     "ldpc_launches_per_call": decode_layered_cuda.launches / N_ROUNDS}
        if name.endswith("slot"):
            recs = [r for o in outs for r in o]
            run[name]["crc_by_rv"] = {
                str(rv): [sum(r["crc_ok"] for r in recs if r["rv"] == rv),
                          sum(1 for r in recs if r["rv"] == rv)] for rv in (0, 3, 2, 1)}
            run[name]["mcs_rank"] = sorted({(r["mcs"], r["rank"]) for r in recs})
    run["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
    run["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"run": run}), flush=True)
    print(json.dumps({"flooding": flooding_cost(loop, dev)}), flush=True)

    range_ms = ranges_cost_ms("pdsch.probe")
    for name in phases:
        fn = phase(name)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(N_ROUNDS):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        summary, ranges_per_call = summarize_profile(prof, RANGE_PREFIXES, N_ROUNDS, wall_us)
        summary["ranges_cost_ms_per_call"] = range_ms * ranges_per_call
        print(json.dumps({f"profile_{name}": summary}), flush=True)


if __name__ == "__main__":
    main()
