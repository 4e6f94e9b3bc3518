#!/usr/bin/env python3
"""Smoke test of the PyTorch port (isac_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines and raises on failure, so any failed phase
gives a non-zero exit code and no final result line):
  1. the card's name and power limit (nvidia-smi), and the build of every
     CUDA kernel of the main path from the sources in the checkout;
  2. each kernel against its plain PyTorch version on the card. 2a the
     threefry normal kernel (csrc/threefry_normal.cu): every one of the 2^23
     uniforms and normals a draw can take, the words and uniforms of the DL
     grid's draw, and complex draws at the slot loop's DL and UL grids and
     the post-pass's [1228800, 16] (scale sqrt(1/2) and a post-pass sigma),
     all bit-equal; one launch a draw; at the DL and post-pass shapes the
     kernel's device time (profiler), the wrapper's wall time a draw (three
     readings of 20 draws), the plain version's time, and the bound.
     2b the layered LDPC kernel, at the
     shapes the main path gives it and at odd shapes (BG2 with punctured
     columns, a ragged lifting size, one codeword, more codewords than two
     CTAs per SM hold, lifting sizes below a warp, one sweep) and on inputs
     that press on its compressed message state (few-level LLRs with ties
     for the minimum, zeros of both signs): posteriors torch.equal, hard bits
     and parity flags equal; kernel time (three readings) and plain-version
     time;
  3. the batched PDSCH link step at 51 PRB / 4 links / MCS 19 / 2 layers on
     the card, with the kernels and with the plain versions, and on the CPU
     (the plain versions that tests/test_torch_link.py holds against the JAX
     reference): crc_ok and tb equal, sinr_db within 1e-3 dB, decoded TBs equal
     to the transmitted ones;
  4. the main path at full width — bench_pdsch's 273 PRB, 4 links, MCS 19,
     2 layers, 16 tx / 2 rx — over distinct TB/noise per step, timed with
     CUDA events; prints pdsch_slot_ms, pdsch_info_mbps, n_ok and the kernel
     launch count of that run, which must be > 0;
  5. the mono-static sensing chain (example_sensing / make_sensing_chain; it
     reaches no hand-written kernel, its device work is PyTorch's own calls):
     5a the chain at 51 PRB on the card against the same code on the CPU (the
     code tests/test_torch_sensing.py holds against the JAX reference), same
     grid and noise array: masks, bins and angles equal, RDM within 2e-5 of
     max|.|; 5b the full width of the reference benchmark's sensing entry —
     273 PRB, 16 antennas, 20 slots, 4096-point range IFFT, 256-point Doppler
     FFT — 8 runs with distinct noise, timed with CUDA events and the host
     clock, each of which must find exactly the detection the JAX package
     finds on the same grid; per-stage times and peak memory; 5c the same
     chain on the DL waveform of the port's own PDSCH transmit on the D slots
     and the DL symbols of the S slots of DDDSU x 4; then the range/velocity MUSIC chain once at full width.
  6. the link loop (example_link_loop: CSI-RS / SRS measurement, RI / PMI /
     CQI / TPMI selection, batched PDSCH / PUSCH through the public per-grant
     functions, HARQ retransmissions with soft combining):
     6a the loop at 51 PRB / 2 UEs on the card against the same loop on the
     CPU from the same numpy inputs: RI, subband PMI and CQI, TPMI, MCS, rv,
     CRC flags equal, TB bits equal wherever the CRC passes, sinr_db within
     0.05 dB, channel estimates within 1e-4 of max|.|; the layered kernel
     against its plain version on the soft-buffer-combined LLRs of that run's
     retransmissions (bit-equal posteriors);
     6b both loops at full width — 273 PRB, 16 gNB ports, 4 two-antenna UEs on
     68 PRBs each: first untimed DL slots through a retransmission round and
     one UL slot, whose every decoder input (new and combined LLRs, at the
     code sizes and batch sizes of this path) goes through the layered kernel
     and its plain version (bit-equal posteriors); then three readings of 8
     timed slots each with distinct TB bits and noise (CUDA events and host
     clock; the noise is the same numpy draw as in 6a, made before the
     window). In every window every CRC-passing TB equals the sent one, at
     least one DL grant fails at rv 0, no TB runs out of the four RVs, every
     UL grant passes, and the kernel's launch count equals the number of
     sch_receive_batch calls;
     6c the flooding decoder: sch_decode(schedule="flooding") on the card
     against the CPU (TB bits and flags equal) and, at 2 x n_iter, against the
     layered kernel at n_iter on the same LLRs (the decoded TBs equal).
  7. the per-cell system-level engine (sim/cell.py CellSimulator through
     example_cell and run()):
     7a the reference's fixed-seed single link at 51 PRB / nfft 1024 with
     traces, on the card and on the CPU in this process: both reproduce
     tests/golden/single_link_trace.json (slot, dir, UE, MCS, PRBs, TBS, CRC,
     rv exact; SINR within 0.1 dB) and agree with each other; then the
     single link at 24 PRB / nfft 512 with the gNB at 10 dBm and the UE at
     -35 dBm, whose failed blocks are retransmitted on combined soft buffers
     in both directions: card and CPU traces agree, and a card checkpoint at
     slot 10 with soft buffers waiting resumes to the straight run;
     7b the shipped open_street_map_city at full width (273 PRB, nfft 4096,
     16 gNB ports, 5 UEs, one target, one frame): one untimed frame whose
     every decoder input goes through the layered kernel and its plain
     version (bit-equal posteriors), then three frames on fresh simulators
     with the same seed, each timed (cell_slot_ms, cell_sensing_ms, host
     clock after synchronize) and held to the JAX engine's numbers at the
     same configuration (CELL_EXPECT): per-UE TB counts and CRC failures
     equal, throughputs within 1%, the same detections within 0.5 m, 0.5
     m/s, 0.5 deg; kernel launches = sch_receive_batch calls.
  8. the top-level entry and the lockstep network (sim/network.py through
     example_network / simulate, topology/ for the city's line of sight):
     8a two co-channel cells of multi_cell at 24 PRB / nfft 512 with DL + UL
     interference and traces, on the card and on the CPU in this process:
     per-cell trace integers (slot, dir, UE, MCS, PRBs, TBS, CRC, rv) equal,
     SINR within 0.05 dB, the DL cross term non-zero in some slot of each
     cell; 8b simulate(open_street_map_city) as shipped (the README's quick
     start: 273 PRB, 16 ports, 5 UEs of which the city leaves one in LoS, one
     frame, sensing on), held to the JAX package's numbers (CITY_EXPECT): per-UE
     BLER exact, throughputs within 1%, the detection within 0.5 m / 0.5 m/s
     / 0.5 deg; 8c two co-channel cells at 273 PRB (example_network): one
     untimed frame with sensing whose every decoder input goes through the
     layered kernel and its plain version (bit-equal posteriors), held to the
     JAX network (NETWORK_EXPECT: per-UE TB counts and CRC failures exact,
     throughputs within 1%, the detections as 8b), then three frames without
     sensing on fresh runners of the same seed, each timed (network_slot_ms,
     network_cell_slots_per_s; host clock after synchronize), held to the
     same counts, with kernel launches = sch_receive_batch calls, peak memory
     and the runner's host ms per slot of each network.* stage.
  9. block mode and distribution:
     9a CellSimulator(block_slots=) on example_cell() at full width: two
     slot-loop frames of seed 0 (a float surface that differs between them is
     named and held at SEGMENT_FLOAT_TOL), then a block_slots=8 and a
     block_slots=1 frame, each equal to the slot loop on every leaf of the
     result (KPIs, per-UE metrics, trace, logs, sensing estimates), held to
     CELL_EXPECT, with kernel launches = sch_receive_batch calls; the
     block_slots=8 frame under the profiler, which must show 0 device-to-host
     copies issued inside the cell.segment ranges (the host-to-device count
     printed beside it); then three block_slots=8 frames on fresh simulators,
     timed (cell_block_slot_ms beside 7b's cell_slot_ms);
     9b a world of one on the card (init_distributed: NCCL): the mesh link step
     at 273 PRB / 4 links against the meshless one (crc_ok and tb equal,
     sinr_db within 1e-3 dB, n_ok = the passes); SyncNetworkRunner(mesh=) on
     example_network() without sensing through network_cross_rx, held to
     NETWORK_EXPECT; CellSimulator(mesh=) at 273 PRB, held to CELL_EXPECT,
     its time-sharded RDM within 2e-5 of max|RDM| of the serial map of the
     same engine and the same detections. The process group is destroyed at
     the end.
  10. seven co-channel cells of multi_cell at 273 PRB (example_network(7):
     the 500 m hex centre cell and its first ring, 5 UEs and one target a
     cell, DL + UL interference, seed 0): the UE and cross-link LoS maps
     exact, then one untimed frame with sensing, held to the JAX network
     (NETWORK7_EXPECT: per-UE TB counts and CRC failures exact, throughputs
     within 1%; detections under the split rule, with the eigenvalues of the
     card's own covariance recorded from music_doa: valid flags exact, ranges
     and velocities within 0.5, the azimuths of the clean part of the signal
     subspace within 0.5 deg, the rest finite), every decoder input through
     the layered kernel and its plain version (bit-equal posteriors); then
     three frames without sensing on fresh runners, each timed
     (network7_slot_ms, network7_cell_slots_per_s, the bank build's seconds,
     host ms per slot of each network.* stage, peak memory), held to the same
     counts, with kernel launches = sch_receive_batch calls.
Then one JSON line of per-kernel numbers, the nvidia-smi line again, and last
{"ok": true, "device": {...}}.

It needs one CUDA card. It exits non-zero, printing no result, when
torch.cuda.is_available() is false or when the package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, at the 700 W limit):
# HBM3 bandwidth and float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# float ops per edge, lane and iteration of the layered min-sum update:
# t = post - msg, |t|, min1 compare, min2 update, sign select, sign product,
# (norm*sprod)*sgn, *mag, t + new
LDPC_OPS_PER_EDGE = 10
# uint32 operations per complex element of the threefry normal kernel: per
# part, 2 key adds, 20 rounds of add, rotate and xor, 5 key injections of 2
# adds, the words' xor, and the uniform's shift and or. Hopper runs 64
# INT32 operations per SM and clock (NVIDIA H100 white paper; 132 SMs at the
# SXM part's 1.98 GHz boost clock).
THREEFRY_INT_OPS = 2 * (2 + 20 * 3 + 5 * 2 + 1 + 2)
PEAK_INT32_OP_S = 132 * 64 * 1.98e9

SLICE_SINR_ATOL_DB = 1e-3


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_cuda(fn, inputs, reps):
    """Mean ms per call over `reps` calls cycling through distinct inputs,
    after one warm-up call, timed with CUDA events."""
    import torch

    fn(inputs[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_device_ms(fn, inputs, reps, kernel):
    """Mean device ms of one launch of the kernel whose name holds `kernel`,
    over the launches the profiler records in `reps` calls after one warm-up
    call (each call launches it once; the profiler can miss one as its
    session starts). Returns (ms, launches recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not 0 < len(us) <= reps:
        raise AssertionError(f"{kernel}: the profiler saw {len(us)} launches in {reps} calls")
    return sum(us) / len(us) / 1e3, len(us)


def _noisy_llrs(bg, z, n_cw, sigma, seed, dev, n_sets=1, puncture=True):
    """Noisy BPSK LLRs of random codewords of the lifted code (numpy seed)."""
    import numpy as np
    import torch

    from isac_tpu_torch.ops import ldpc

    code = ldpc.lifted_code(bg, z)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sets):
        msg = torch.as_tensor(rng.integers(0, 2, (n_cw, code.k)).astype(np.int8), device=dev)
        cw = ldpc.encode(code, msg).cpu().numpy().astype(np.float32)
        y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
        llr = (2.0 * y / sigma**2).astype(np.float32)
        if puncture:
            llr[:, : 2 * z] = 0.0
        out.append(torch.as_tensor(llr, device=dev))
    return out


def _pressed_llrs(kind, bg, z, n_cw, seed, dev):
    """LLRs that press on the kernel's compressed message state: a few levels
    only, so that several edges of a row tie for the minimum ("ties"), the
    same with zeros of both signs sprinkled in ("negzeros"), or nothing but
    zeros, half of the codewords -0.0 ("zeros")."""
    import numpy as np
    import torch

    from isac_tpu_torch.ops import ldpc

    rng = np.random.default_rng(seed)
    shape = (n_cw, ldpc.lifted_code(bg, z).n_full)
    if kind == "zeros":
        llr = np.zeros(shape, np.float32)
        llr[::2] = -0.0
    else:
        llr = (rng.integers(1, 4, shape) * rng.choice([-0.5, 0.5], shape)).astype(np.float32)
        if kind == "negzeros":
            llr[rng.random(shape) < 0.2] = -0.0
            llr[rng.random(shape) < 0.1] = 0.0
    return torch.as_tensor(llr, device=dev)


# the slot loop's DL and UL grids and the drops' post-pass draw (273 PRB,
# 5 UEs, 16 gNB ports; 20 slots of nfft 4096 with their cyclic prefixes)
THREEFRY_SHAPES = {"dl": (5, 2, 14, 3276), "ul": (5, 16, 14, 3276), "post_pass": (1228800, 16)}


def phase_threefry(dev):
    """Phase 2a: the threefry normal kernel against its plain version."""
    import numpy as np
    import torch

    from isac_tpu_torch.utils import prng

    uniform, normal = prng.normal_table_cuda(dev)
    bits = torch.arange(1 << 23, dtype=torch.int64, device=dev) << 9
    u = prng.uniform_from_bits(bits)
    plain = prng.erf_inv(u) * prng._SQRT2
    if not torch.equal(uniform.view(torch.int32), u.view(torch.int32)):
        raise AssertionError("threefry_normal: a uniform of the table differs")
    k32, p32 = normal.view(torch.int32).to(torch.int64), plain.view(torch.int32).to(torch.int64)
    n_diff, gap = int((k32 != p32).sum()), int((k32 - p32).abs().max())
    max_err = float((normal - plain).abs().max())
    print(f"kernel threefry_normal table: 2^23 uniforms equal; normals differing {n_diff}, "
          f"largest gap {gap} ulp, max |kernel - plain| {max_err}", flush=True)
    if n_diff:
        raise AssertionError(f"threefry_normal: {n_diff} normals of the table differ")
    del uniform, normal, bits, u, plain

    key = np.random.SeedSequence([20261018, 7, 7]).generate_state(2).astype(np.uint32)
    kr, ki = prng.split(key)
    words = prng.complex_normal_cuda(key, THREEFRY_SHAPES["dl"], dev, what="bits")
    for part, k in ((0, kr), (1, ki)):
        if not torch.equal(words[..., part], prng.random_bits(k, THREEFRY_SHAPES["dl"], dev)):
            raise AssertionError("threefry_normal: the words of the DL draw differ")
    sigma = float(np.float32(np.sqrt(1.380649e-23 * 290.0 * 10**0.7 * 122.88e6 / 2.0)))
    cases = [(name, shape, prng._SQRT_HALF) for name, shape in THREEFRY_SHAPES.items()]
    cases.append(("post_pass", THREEFRY_SHAPES["post_pass"], sigma))
    for name, shape, scale in cases:
        before = prng.complex_normal_cuda.launches
        got = prng.complex_normal(key, shape, dev, scale=scale)
        want = prng.complex_normal(key, shape, dev, scale=scale, impl="torch")
        torch.cuda.synchronize()
        if prng.complex_normal_cuda.launches != before + 1:
            raise AssertionError("threefry_normal: a draw took other than one launch")
        if not torch.equal(torch.view_as_real(got).view(torch.int32),
                           torch.view_as_real(want).view(torch.int32)):
            raise AssertionError(f"threefry_normal {name} {shape} scale {scale}: differs")
        max_err = max(max_err, float((got - want).abs().max()))
        print(f"kernel threefry_normal {name} {shape} scale {scale:.6g}: bit-equal, one launch",
              flush=True)
    del got, want

    timed = {}
    for name in ("dl", "post_pass"):
        shape = THREEFRY_SHAPES[name]
        keys = [np.random.SeedSequence([20261018, 7, s]).generate_state(2).astype(np.uint32)
                for s in range(4)]
        device_ms, seen = _kernel_device_ms(lambda k: prng.complex_normal(k, shape, dev), keys,
                                            10, "threefry_normal_kernel")
        wall = [_time_cuda(lambda k: prng.complex_normal(k, shape, dev), keys, 20)
                for _ in range(3)]
        plain_ms = _time_cuda(
            lambda k: prng.complex_normal(k, shape, dev, impl="torch"), keys, 3)
        n = int(np.prod(shape))
        bytes_ms = 8 * n / PEAK_BYTES_S * 1e3
        ops_ms = THREEFRY_INT_OPS * n / PEAK_INT32_OP_S * 1e3
        timed[name] = {"ms": device_ms, "wall_ms_readings": wall,
                       "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        print(f"kernel threefry_normal {name} {shape}: kernel {device_ms:.4f} device ms "
              f"(profiler, {seen} of 10 launches recorded); wrapper wall time "
              + " ".join(f"{r:.4f}" for r in wall)
              + f" ms a draw (CUDA events, 3 readings of 20 draws); plain {plain_ms:.3f} ms, "
              f"bound {timed[name]['bound_ms']:.4f} ms ({timed[name]['bound_by']})", flush=True)
    return timed, max_err


MAIN_CASE = (1, 384, 116, 6)  # the 273-PRB main path: C=29 code blocks x 4 links


def phase_kernels(dev):
    """Phase 2b: the layered LDPC kernel against its plain version."""
    import torch

    from isac_tpu_torch.ops import ldpc
    from isac_tpu_torch.ops.ldpc_layered import decode_layered, layered_posterior

    cases = [  # (bg, z, codewords, iterations, sigma or the kind of pressed input)
        (*MAIN_CASE, 0.9),
        (2, 64, 4, 4, 0.8),  # BG2 with punctured columns, as tests/test_ldpc.py
        (2, 52, 8, 6, 0.85),  # ragged lifting size (Z not a multiple of 32)
        (1, 160, 12, 6, 0.9),
        (1, 384, 1, 6, 0.9),
        (1, 384, 300, 6, 0.9),  # more CTAs than two per SM hold
        (1, 2, 40, 6, 0.9),  # less than one warp per codeword
        (1, 20, 300, 6, 0.9),  # the same, several codewords per CTA
        (2, 384, 20, 6, 0.85),
        (*MAIN_CASE[:3], 1, 0.9),  # only the sweep that reads no message
        (*MAIN_CASE, "ties"), (*MAIN_CASE, "negzeros"), (2, 52, 8, 6, "ties"),
        (2, 64, 4, 4, "negzeros"), (1, 20, 300, 3, "zeros"),
        # after one sweep the signs of zeros are still in the posterior
        (*MAIN_CASE[:3], 1, "negzeros"), (2, 52, 8, 1, "negzeros"),
    ]
    max_err = 0.0
    main = None
    for bg, z, n_cw, n_iter, sigma in cases:
        timed = (bg, z, n_cw, n_iter, sigma) == cases[0]
        seed = bg * 1000 + z
        if isinstance(sigma, str):
            llrs = [_pressed_llrs(sigma, bg, z, n_cw, seed, dev)]
        else:
            llrs = _noisy_llrs(bg, z, n_cw, sigma, seed, dev, n_sets=4 if timed else 1)
        pk = layered_posterior(llrs[0], bg, z, n_iter, impl="cuda")
        pt = layered_posterior(llrs[0], bg, z, n_iter, impl="torch")
        torch.cuda.synchronize()
        err = float((pk - pt).abs().max())
        max_err = max(max_err, err)
        # bit patterns, so that -0.0 and +0.0 count as different
        if not torch.equal(pk.view(torch.int32), pt.view(torch.int32)):
            raise AssertionError(f"ldpc_layered BG{bg} Z={z} x{n_cw} it{n_iter} {sigma}: "
                                 f"posterior differs, max |err| {err}")
        hk, ok_k = decode_layered(llrs[0], bg, z, n_iter, impl="cuda")
        ht, ok_t = decode_layered(llrs[0], bg, z, n_iter, impl="torch")
        if not (torch.equal(hk, ht) and torch.equal(ok_k, ok_t)):
            raise AssertionError(f"ldpc_layered BG{bg} Z={z}: hard bits or parity flags differ")
        line = (f"kernel ldpc_layered BG{bg} Z={z} x{n_cw} it{n_iter} {sigma}: posterior "
                f"bit-equal, parity ok {int(ok_k.sum())}/{n_cw}")
        if timed:
            readings = [_time_cuda(lambda x: layered_posterior(x, bg, z, n_iter, impl="cuda"),
                                   llrs, 20) for _ in range(3)]
            plain_ms = _time_cuda(lambda x: layered_posterior(x, bg, z, n_iter, impl="torch"),
                                  llrs, 3)
            code = ldpc.lifted_code(bg, z)
            e = int(code.rows.shape[0])
            io_bytes = 2 * n_cw * code.n_full * 4  # llr read once, posterior written once
            ops = n_cw * n_iter * e * z * LDPC_OPS_PER_EDGE
            bytes_ms = io_bytes / PEAK_BYTES_S * 1e3
            ops_ms = ops / PEAK_F32_FLOP_S * 1e3
            # the compressed state: 3 words per (row, lane), written by every
            # sweep but the last and read by every sweep but the first
            state_bytes = n_cw * 2 * (n_iter - 1) * code.n_rows * z * 12
            main = {
                "ms": sorted(readings)[1], "ms_readings": readings, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "msg_traffic_bound_ms": (io_bytes + state_bytes) / PEAK_BYTES_S * 1e3,
            }
            line += ("; kernel " + " ".join(f"{r:.4f}" for r in readings)
                     + f" ms (3 readings of 20 calls), plain {plain_ms:.3f} ms")
        print(line, flush=True)
    return main, max_err


def phase_slice_parity(dev):
    """Phase 3: link step with kernels vs plain versions, on the card and CPU."""
    import torch

    from isac_tpu_torch.example import example_link_batch
    from isac_tpu_torch.parallel.links import make_link_step

    g, args, tbs = example_link_batch(n_prb=51, n_links=4, mcs=19, n_layers=2, device=dev)
    outs = {
        "cuda": make_link_step(g, device=dev)[0](*args),
        "cuda-plain": make_link_step(g, device=dev, impl="torch")[0](*args),
        "cpu-plain": make_link_step(g, device="cpu")[0](*(a.cpu() for a in args)),
    }
    ref = {k: v.cpu() for k, v in outs["cuda"].items()}
    for name in ("cuda-plain", "cpu-plain"):
        o = {k: v.cpu() for k, v in outs[name].items()}
        if not (torch.equal(o["crc_ok"], ref["crc_ok"]) and torch.equal(o["tb"], ref["tb"])):
            raise AssertionError(f"slice parity: crc_ok/tb differ between cuda and {name}")
        d = float((o["sinr_db"] - ref["sinr_db"]).abs().max())
        if not d <= SLICE_SINR_ATOL_DB:
            raise AssertionError(f"slice parity: sinr_db differs by {d} dB vs {name}")
        print(f"slice 51 PRB x4 links: cuda vs {name}: crc_ok/tb equal, "
              f"max |d sinr_db| {d:.3g} dB", flush=True)
    ok = ref["crc_ok"]
    if not torch.equal(ref["tb"][ok], args[0].cpu()[ok]):
        raise AssertionError("slice: a CRC-passing TB differs from the transmitted one")
    if not (ref["tb"].shape == (4, tbs) and torch.isfinite(ref["sinr_db"]).all() and ok.all()):
        raise AssertionError(f"slice: unexpected output {ref['crc_ok']} {ref['sinr_db']}")
    print(f"slice 51 PRB: crc_ok {ok.tolist()} sinr_db {ref['sinr_db'].tolist()}", flush=True)


def phase_main_path(dev, n_steps=8):
    """Phase 4: the link step at bench_pdsch's full width."""
    import torch

    from isac_tpu_torch.example import example_link_batch
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda
    from isac_tpu_torch.parallel.links import make_link_step

    n_prb, n_links = 273, 4
    t0 = time.perf_counter()
    g, (tb, w, h, noise), tbs = example_link_batch(n_prb=n_prb, n_links=n_links, mcs=19,
                                                   n_layers=2, device=dev)
    step, _ = make_link_step(g, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tbs_in = [torch.randint(0, 2, tb.shape, generator=gen, device=dev, dtype=torch.int8)
              for _ in range(n_steps)]
    noises = [torch.complex(torch.randn(noise.shape, generator=gen, device=dev),
                            torch.randn(noise.shape, generator=gen, device=dev)) * 0.5**0.5
              for _ in range(n_steps)]
    step(tbs_in[0], w, h, noises[0])  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    decode_layered_cuda.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    outs = [step(tbs_in[i], w, h, noises[i]) for i in range(n_steps)]
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    launches = decode_layered_cuda.launches
    slot_ms = start.elapsed_time(end) / n_steps
    n_ok = 0
    for i, o in enumerate(outs):
        ok = o["crc_ok"]
        n_ok += int(ok.sum())
        if not torch.equal(o["tb"][ok], tbs_in[i][ok]):
            raise AssertionError(f"main path step {i}: a CRC-passing TB differs from the sent one")
        if not (o["tb"].shape == (n_links, tbs) and torch.isfinite(o["sinr_db"]).all()):
            raise AssertionError(f"main path step {i}: bad output shapes or values")
    if launches <= 0:
        raise AssertionError("main path did not launch the ldpc_layered kernel")
    if n_ok == 0:
        raise AssertionError("main path: no transport block decoded")
    res = {
        "pdsch_slot_ms": slot_ms,
        "pdsch_host_slot_ms": host_s / n_steps * 1e3,
        "pdsch_info_mbps": tbs * n_links / (slot_ms / 1e3) / 1e6,
        "n_ok": n_ok, "n_tb": n_steps * n_links, "tbs": tbs,
        "ldpc_layered_launches": launches, "setup_s": setup_s,
        "sinr_db_last": outs[-1]["sinr_db"].tolist(),
    }
    print("main path 273 PRB x4 links MCS19 2 layers: " + json.dumps(res), flush=True)
    return res


# What the JAX package finds at the full-width sensing inputs (its CPU backend,
# same grid; the noise is ~55 dB under the echo, so the bins do not depend on
# the draw): one CFAR detection at range bin 107, Doppler bin 129, MUSIC azimuth
# 18.0 deg (truth: 129.66 m, 7 m/s, 18.43 deg), no elevation from a ULA.
SENSING_EXPECT = {"n_ifft": 4096, "n_fft": 256, "range_bin": 107, "doppler_bin": 129,
                  "azimuth_deg": 18.0, "rngRMSE": 0.863, "velRMSE": 2.438, "aziRMSE": 0.435}
SENSING_RDM_TOL = 2e-5  # of max|RDM|: float32 products and FFTs of two libraries


def _sensing_gnb():
    """The reference benchmark's gNB: defaults (3.5 GHz, 100 MHz at SCS 30 kHz =
    273 PRB, 44 dBm, DDDSU) with the 8 x 2-pol ULA."""
    from isac_tpu_torch.config import ULA, GNBParams

    return GNBParams(antenna=ULA(n_v=8, polarizations=2))


def _host_estimates(est):
    return {k: v.cpu().numpy() for k, v in est.items() if k != "rdm"}


def _same_masked(a, b):
    """Equal arrays, NaN (masked-out entries) in the same places."""
    import numpy as np

    return a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def phase_sensing_parity(dev):
    """Phase 5a: the sensing chain at small size, card against CPU."""
    import numpy as np
    import torch

    from isac_tpu_torch.config import ULA, GNBParams
    from isac_tpu_torch.example import example_sensing

    gnb = GNBParams(dl_bandwidth=20e6, ul_bandwidth=20e6, antenna=ULA(n_v=8, polarizations=2))
    targets = (((120.0, 40.0, 1.5), (70.0, -60.0, 1.5)), (3.3, 1.0), (20.0, -25.0))
    num_slots = 10
    outs = {}
    noise = None
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        chain, params, grids = example_sensing(num_slots=num_slots, seed=3, device=d, gnb=gnb,
                                               targets=targets)
        if noise is None:
            n = int(gnb.carrier.ofdm.symbol_lengths_slots(num_slots).sum())
            rng = np.random.default_rng(4)
            noise = (np.sqrt(params.n0 / 2.0) * (rng.standard_normal((n, gnb.num_tx_ants))
                     + 1j * rng.standard_normal((n, gnb.num_tx_ants)))).astype(np.complex64)
        est = chain(grids, torch.as_tensor(noise, device=d))
        outs[name] = (_host_estimates(est), est["rdm"].cpu())
    (got, rdm_g), (want, rdm_c) = outs["cuda"], outs["cpu"]
    for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst", "eleEst"):
        if not _same_masked(got[k], want[k]):
            raise AssertionError(f"sensing parity: {k} differs: card {got[k]} vs CPU {want[k]}")
    err = float((rdm_g - rdm_c).abs().max() / rdm_c.abs().max())
    if not err <= SENSING_RDM_TOL:
        raise AssertionError(f"sensing parity: RDM differs by {err} of max|.|")
    n_det = int(want["valid"].sum())
    if n_det < 2:
        raise AssertionError(f"sensing parity: {n_det} detections for two targets")
    print(f"sensing 51 PRB x16 ants x{num_slots} slots, 2 targets: card vs CPU: masks, bins and "
          f"angles equal ({n_det} detections, rngEst {want['rngEst'][:n_det].tolist()}, aziEst "
          f"{want['aziEst'][:2].tolist()}), max |d RDM| {err:.3g} of max (tolerance "
          f"{SENSING_RDM_TOL})", flush=True)


def _check_full_width_estimate(est, params, what):
    """The one detection SENSING_EXPECT states, or AssertionError."""
    import numpy as np

    from isac_tpu_torch.ops.sensing import get_rmse

    e = _host_estimates(est)
    exp = SENSING_EXPECT
    n_det = int(e["valid"].sum())
    if n_det != 1 or not e["valid"][0]:
        raise AssertionError(f"{what}: {n_det} CFAR detections, expected one: {e['rngEst']}")
    r_bin = int(round(float(e["rngEst"][0]) / params.r_res))
    d_bin = int(round(float(e["velEst"][0]) / params.v_res + params.n_fft / 2))
    az = float(e["aziEst"][0])
    if (r_bin, d_bin, az) != (exp["range_bin"], exp["doppler_bin"], exp["azimuth_deg"]):
        raise AssertionError(f"{what}: range bin {r_bin}, Doppler bin {d_bin}, azimuth {az}; "
                             f"expected {exp['range_bin']}, {exp['doppler_bin']}, "
                             f"{exp['azimuth_deg']}")
    if not (np.isnan(e["eleEst"]).all() and np.isnan(e["aziEst"][1:]).all()):
        raise AssertionError(f"{what}: eleEst {e['eleEst']} aziEst {e['aziEst']}")
    rep = get_rmse(e, params)
    if (rep["numMatched"], rep["numTargets"]) != (1, 1):
        raise AssertionError(f"{what}: get_rmse matched {rep['numMatched']} of {rep['numTargets']}")
    for k in ("rngRMSE", "velRMSE", "aziRMSE"):
        if abs(rep[k] - exp[k]) > 1e-3:
            raise AssertionError(f"{what}: {k} {rep[k]} expected {exp[k]}")
    return e, rep


def _sensing_stage_ms(chain_parts, grid, gen, reps=4):
    """CUDA-event ms per stage of the chain, the stages called one by one."""
    import torch

    from isac_tpu_torch.ops.ofdm import ofdm_demodulate, ofdm_modulate
    from isac_tpu_torch.ops.sensing import (apply_radar_channel, cfar_detect_map,
                                            cfar_extract_detections, music_doa,
                                            range_doppler_map, spatial_covariance)

    params, cfg, info, n_sc, num_slots = chain_parts
    names = ("ofdm_modulate", "echo", "ofdm_demodulate", "rdm", "cfar", "covariance_music")
    total = dict.fromkeys(names, 0.0)
    for rep in range(reps + 1):  # the first pass warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        wave = ofdm_modulate(grid, info).T
        ev[1].record()
        rx = apply_radar_channel(wave, params, gen)
        ev[2].record()
        rx_grid = ofdm_demodulate(rx.T, info, n_sc, num_slots)
        ev[3].record()
        rdm = range_doppler_map(rx_grid, grid, params.n_ifft, params.n_fft)
        ev[4].record()
        power = torch.abs(rdm) ** 2
        det = cfar_detect_map(power, cfg).any(dim=0)
        dets = cfar_extract_detections(power.amax(dim=0), det, cfg)
        ev[5].record()
        music_doa(spatial_covariance(rx_grid), params, num_detections=dets["valid"].sum())
        ev[6].record()
        torch.cuda.synchronize()
        del wave, rx, rx_grid, rdm, power, det
        if rep:
            for i, name in enumerate(names):
                total[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    return total


def phase_sensing_full(dev, n_runs=8):
    """Phase 5b: the sensing chain at the reference benchmark's full width."""
    import torch

    from isac_tpu_torch.example import example_sensing
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda
    from isac_tpu_torch.ops.sensing import make_cfar_config

    num_slots = 20
    gnb = _sensing_gnb()
    carrier = gnb.carrier
    t0 = time.perf_counter()
    chain, params, grids = example_sensing(num_slots=num_slots, seed=0, device=dev, gnb=gnb)
    exp = SENSING_EXPECT
    if (params.n_ifft, params.n_fft) != (exp["n_ifft"], exp["n_fft"]):
        raise AssertionError(f"sensing: n_ifft {params.n_ifft} n_fft {params.n_fft}")
    if tuple(grids[0].shape) != (16, 280, 3276) or carrier.ofdm.nfft != 4096:
        raise AssertionError(f"sensing: grid shape {tuple(grids[0].shape)}")
    gens = []
    for i in range(n_runs + 1):
        g = torch.Generator(device=dev)
        g.manual_seed(700 + i)
        gens.append(g)
    _check_full_width_estimate(chain(grids, gens[-1]), params, "sensing warm-up")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    decode_layered_cuda.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    ests = []
    for i in range(n_runs):
        est = chain(grids, gens[i])
        del est["rdm"]  # 134 MB a run; the checks below read the estimates only
        ests.append(est)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    chain_ms = start.elapsed_time(end) / n_runs
    for i, est in enumerate(ests):
        e, rep = _check_full_width_estimate(est, params, f"sensing run {i}")
    chain_parts = (params, make_cfar_config(params), carrier.ofdm, carrier.n_sc, num_slots)
    stages = _sensing_stage_ms(chain_parts, grids[0], gens[0])
    res = {
        "sensing_chain_ms": chain_ms, "sensing_host_ms": host_s / n_runs * 1e3,
        "rdm_per_s": 1e3 / chain_ms, "n_runs": n_runs,
        "n_ifft": params.n_ifft, "n_fft": params.n_fft,
        "range_bin": exp["range_bin"], "doppler_bin": exp["doppler_bin"],
        "rngEst": float(e["rngEst"][0]), "velEst": float(e["velEst"][0]),
        "aziEst": float(e["aziEst"][0]), "peak": float(e["peak"][0]),
        "rngRMSE": rep["rngRMSE"], "velRMSE": rep["velRMSE"], "aziRMSE": rep["aziRMSE"],
        "matched": rep["numMatched"], "targets": rep["numTargets"],
        "peak_memory_mb": peak_mb, "resident_before_mb": base_mb, "setup_s": setup_s,
        "ldpc_layered_launches_in_sensing": decode_layered_cuda.launches,
    }
    print("sensing 273 PRB x16 ants x20 slots (FFT + MUSIC DoA): " + json.dumps(res), flush=True)
    print("sensing stage ms (CUDA events, stages called one by one, mean of 4): "
          + json.dumps(stages), flush=True)
    return params, grids


def phase_sensing_isac(dev):
    """Phase 5c: the chain on the DL waveform of the port's PDSCH transmit."""
    import numpy as np
    import torch

    from isac_tpu_torch.ops.precoding import csirs_panel_dims, type1_codebook
    from isac_tpu_torch.ops.sensing import get_rmse
    from isac_tpu_torch.phy.chains import (SCHGrant, _dmrs_refs, _layout, _make_tx_fn,
                                           _scrambling_seq, grant_tbs)
    from isac_tpu_torch.sim.sensing import make_sensing_chain

    gnb = _sensing_gnb()
    carrier = gnb.carrier
    n_prb, n_sc, n_tx, num_slots = carrier.n_rb, carrier.n_sc, gnb.num_tx_ants, 20
    tdd = gnb.tdd
    # the slots that carry DL, as the per-slot engine records them for sensing:
    # every D slot whole and the DL symbols of every S slot
    starts = tuple(s for s in range(num_slots) if tdd.slot_type(s) in "DS")
    widths = tuple(14 if tdd.slot_type(s) == "D" else tdd.num_dl_syms for s in starts)
    txs = {}
    for n_sym in sorted(set(widths)):
        grant = SCHGrant(n_prb=n_prb, n_layers=2, mcs=19, n_sc_grid=n_sc, n_sym=n_sym)
        key = grant.layout_key()
        lay = _layout(key)
        txs[n_sym] = (grant, _make_tx_fn(key),
                      torch.as_tensor(_scrambling_seq(grant, lay["cfg"].g), device=dev),
                      torch.as_tensor(_dmrs_refs(grant, lay["dsyms"]), device=dev))
    rng = np.random.default_rng(5)
    cb = type1_codebook(*csirs_panel_dims(n_tx), 2)
    amp = float(10 ** ((gnb.tx_power_dbm - 30) / 20)
                * np.sqrt(carrier.ofdm.nfft**2 / (n_sc * n_tx)))
    grids = []
    for n_sym in widths:  # a new TB and new random PRG precoders in every slot
        grant, tx, seq, refs = txs[n_sym]
        tb = torch.as_tensor(rng.integers(0, 2, (1, grant_tbs(grant))).astype(np.int8), device=dev)
        w = torch.as_tensor(cb[rng.integers(0, cb.shape[0], (n_prb + 1) // 2)][None], device=dev)
        port_grid = tx(tb, seq, refs, grant.prbs, grant.rv, w)[0]  # [n_tx, 14, n_sc]
        grids.append(port_grid[:, :n_sym] * amp)
    chain, params = make_sensing_chain(
        gnb, carrier, ((120.0, 40.0, 1.5),), (1.0,), (7.0,), num_slots, starts, widths,
        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    e = _host_estimates(chain(grids, gen))
    t = params.truth[0]
    hit = (e["valid"] & (np.abs(e["rngEst"] - t["Range"]) <= params.r_res)
           & (np.abs(e["velEst"] - t["Velocity"]) <= params.v_res))
    az_err = float(np.nanmin(np.abs(e["aziEst"] - t["Azimuth"])))
    if not (hit.any() and az_err <= 1.0):
        raise AssertionError(f"ISAC link: target not found within one bin: rngEst {e['rngEst']} "
                             f"velEst {e['velEst']} aziEst {e['aziEst']} truth {t}")
    rep = get_rmse(e, params)
    i = int(np.argmax(hit))
    print(f"ISAC link: PDSCH waveform of the {len(starts)} D and S slots of DDDSU x4 ({n_prb} PRB, 2 "
          f"layers, {n_tx} tx) -> {int(e['valid'].sum())} detections; target at rngEst {e['rngEst'][i]:.3f} m "
          f"(truth {t['Range']:.3f}, r_res {params.r_res:.4f}), velEst {e['velEst'][i]:.3f} m/s "
          f"(truth {t['Velocity']}, v_res {params.v_res:.4f}), azimuth error {az_err:.3f} deg; "
          f"get_rmse matched {rep['numMatched']} of {rep['numTargets']}", flush=True)


def phase_sensing_music_2d(dev, params, grids):
    """The range/velocity MUSIC chain once at full width (a 3276 x 3276 eigh)."""
    import torch

    from isac_tpu_torch.ops.ofdm import ofdm_demodulate, ofdm_modulate
    from isac_tpu_torch.ops.sensing import apply_radar_channel, music_2d_estimate

    carrier = _sensing_gnb().carrier
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rx = apply_radar_channel(ofdm_modulate(grids[0], carrier.ofdm).T, params, gen)
    rx_grid = ofdm_demodulate(rx.T, carrier.ofdm, carrier.n_sc, 20)
    del rx
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = music_2d_estimate(rx_grid, grids[0], params)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    e = _host_estimates(est)
    t = params.truth[0]
    if not (e["valid"].any() and torch.isfinite(torch.as_tensor(e["rngEst"][e["valid"]])).all()):
        raise AssertionError(f"music_2d_estimate: no valid estimate: {e}")
    print(f"music_2d_estimate at full width (n_sc {carrier.n_sc} x n_sym 280, first call): "
          f"music_2d_ms {ms:.1f} by the host clock; rngEst {e['rngEst'].tolist()} velEst "
          f"{e['velEst'].tolist()} aziEst {e['aziEst'].tolist()} (truth {t['Range']:.2f} m, "
          f"{t['Velocity']} m/s, {t['Azimuth']:.2f} deg)", flush=True)


LOOP_SINR_ATOL_DB = 0.05
LOOP_H_RTOL = 1e-4


def _loop_records(recs):
    return [(r["ue"], r["rv"], r["mcs"], r["rank"], r["crc_ok"]) for r in recs]


@contextlib.contextmanager
def _recording_layered():
    """Within the block, every CUDA call that the receive chain hands to the
    layered decoder is kept as (llr, bg, z, n_iter) in the yielded list."""
    from isac_tpu_torch.ops import transport

    seen = []
    real = transport.decode_layered

    def recorder(llr, bg, z, n_iter=6, impl=None):
        if llr.is_cuda:
            seen.append((llr.detach().clone(), bg, z, n_iter))
        return real(llr, bg, z, n_iter=n_iter, impl=impl)

    transport.decode_layered = recorder
    try:
        yield seen
    finally:
        transport.decode_layered = real


@contextlib.contextmanager
def _counting_draws(program_counts=False):
    """Within the block, the noise draws of the main path: the engine's
    `_noise` calls, every `prng.complex_normal` call (the `_noise` draws and
    the sensing post-pass's) and the real normals they drew; on leaving, the
    threefry kernel's launches, counted from 0 on entry. program_counts:
    also the port's own counters `prng.normals` and `prng.kernel_normals`
    (tracing recorded: for frames that are not timed)."""
    from isac_tpu_torch.sim.cell import CellSimulator
    from isac_tpu_torch.utils import prng, tracing

    seen = {"noise": 0, "draws": 0, "normals": 0}
    real_noise, real_draw = CellSimulator._noise, prng.complex_normal

    def noise(self, shape, key):
        seen["noise"] += 1
        return real_noise(self, shape, key)

    def draw(*args, **kwargs):
        out = real_draw(*args, **kwargs)
        seen["draws"] += 1
        seen["normals"] += 2 * out.numel()
        return out

    CellSimulator._noise, prng.complex_normal = noise, draw
    prng.complex_normal_cuda.launches = 0
    if program_counts:
        tracing.reset()
        tracing.enable()
    try:
        yield seen
    finally:
        CellSimulator._noise, prng.complex_normal = real_noise, real_draw
        seen["launches"] = prng.complex_normal_cuda.launches
        if program_counts:
            recs = tracing.records()
            tracing.disable()
            tracing.reset()
            for k in ("prng.normals", "prng.kernel_normals"):
                seen[k] = sum(r.counts.get(k, 0) for r in recs)


def _held_draws(seen, post_pass, what):
    """Every noise draw of a full-width run went through the threefry
    kernel: one launch a draw, the engine's `_noise` draws and `post_pass`
    post-pass draws and nothing else, and where recorded, the port's
    counters equal to the normals drawn. Returns the counts."""
    n_post = seen["draws"] - seen["noise"]
    if seen["noise"] <= 0 or n_post != post_pass or seen["launches"] != seen["draws"]:
        raise AssertionError(f"{what}: {seen['launches']} threefry launches for "
                             f"{seen['noise']} _noise draws and {n_post} other draws "
                             f"({post_pass} post-pass draws expected)")
    out = {"launches": seen["launches"], "noise_draws": seen["noise"],
           "post_pass_draws": n_post}
    if "prng.normals" in seen:
        if not seen["prng.kernel_normals"] == seen["prng.normals"] == seen["normals"]:
            raise AssertionError(f"{what}: prng.kernel_normals {seen['prng.kernel_normals']}, "
                                 f"prng.normals {seen['prng.normals']}, {seen['normals']} "
                                 f"normals drawn")
        out["kernel_normals"] = seen["prng.kernel_normals"]
    return out


def _kernel_equals_plain(calls, what):
    """The kernel against its plain version on recorded decoder inputs, by
    bit pattern of the posterior. Returns (max |err|, sorted (bg, z, codewords))."""
    import torch

    from isac_tpu_torch.ops.ldpc_layered import layered_posterior

    err = 0.0
    for llr, bg, z, n_iter in calls:
        flat = llr.reshape(-1, llr.shape[-1])
        pk = layered_posterior(flat, bg, z, n_iter, impl="cuda")
        pt = layered_posterior(flat, bg, z, n_iter, impl="torch")
        err = max(err, float((pk - pt).abs().max()))
        if not torch.equal(pk.view(torch.int32), pt.view(torch.int32)):
            raise AssertionError(f"ldpc_layered on {what} BG{bg} Z={z} x{flat.shape[0]}: "
                                 f"posterior differs, max |err| {err}")
    shapes = sorted({(bg, z, int(llr.reshape(-1, llr.shape[-1]).shape[0]))
                     for llr, bg, z, _ in calls})
    return err, shapes


def phase_loop_parity(dev):
    """Phase 6a: the link loop at 51 PRB / 2 UEs, card against CPU, and the
    kernel on the combined LLRs of the run's retransmissions."""
    import numpy as np

    from isac_tpu_torch.example import example_link_loop

    kw = dict(n_prb=51, n_ues=2, n_tx=16, n_ue_ants=2, seed=0)
    loops = {"cuda": example_link_loop(device=dev, **kw),
             "cpu": example_link_loop(device="cpu", **kw)}
    with _recording_layered() as seen:
        rngs = {k: np.random.default_rng(1) for k in loops}
        csi = {k: loops[k].csi_report(rngs[k]) for k in loops}
        for a, b in zip(csi["cuda"], csi["cpu"]):
            if not (a["rank"] == b["rank"] and np.array_equal(a["pmi_sb"], b["pmi_sb"])
                    and np.array_equal(a["cqi_sb"], b["cqi_sb"])):
                raise AssertionError(f"loop parity: CSI report differs: {a} vs {b}")
            d = float((a["h_est"].cpu() - b["h_est"]).abs().max() / b["h_est"].abs().max())
            if not d <= LOOP_H_RTOL:
                raise AssertionError(f"loop parity: CSI-RS estimate differs by {d} of max|H|")
        retx_calls, max_dsinr = [], 0.0
        for s in range(6):
            n0 = len(seen)
            rec = {k: loops[k].dl_slot(rngs[k]) for k in loops}
            if _loop_records(rec["cuda"]) != _loop_records(rec["cpu"]):
                raise AssertionError(f"loop parity DL slot {s}: {_loop_records(rec['cuda'])} vs "
                                     f"{_loop_records(rec['cpu'])}")
            for a, b in zip(rec["cuda"], rec["cpu"]):
                if a["crc_ok"] and not (np.array_equal(a["tb"], b["tb"]) and a["tb_equal"]):
                    raise AssertionError(f"loop parity DL slot {s}: TB bits differ")
                max_dsinr = max(max_dsinr, abs(a["sinr_db"] - b["sinr_db"]))
            if any(r["rv"] != 0 for r in rec["cuda"]):
                retx_calls += seen[n0:]
        srs = {k: loops[k].srs_report(rngs[k]) for k in loops}
        for a, b in zip(srs["cuda"], srs["cpu"]):
            if not ((a["rank"], a["tpmi"]) == (b["rank"], b["tpmi"])
                    and np.array_equal(a["cqi_sb"], b["cqi_sb"])):
                raise AssertionError(f"loop parity: SRS report differs: {a} vs {b}")
            d = float((a["h_est"].cpu() - b["h_est"]).abs().max() / b["h_est"].abs().max())
            if not d <= LOOP_H_RTOL:
                raise AssertionError(f"loop parity: SRS estimate differs by {d} of max|H|")
        for s in range(2):
            rec = {k: loops[k].ul_slot(rngs[k]) for k in loops}
            if _loop_records(rec["cuda"]) != _loop_records(rec["cpu"]):
                raise AssertionError(f"loop parity UL slot {s}: {_loop_records(rec['cuda'])} vs "
                                     f"{_loop_records(rec['cpu'])}")
            for a, b in zip(rec["cuda"], rec["cpu"]):
                if not (a["crc_ok"] and a["tb_equal"] and np.array_equal(a["tb"], b["tb"])):
                    raise AssertionError(f"loop parity UL slot {s}: TB lost or differs")
                max_dsinr = max(max_dsinr, abs(a["sinr_db"] - b["sinr_db"]))
    if not max_dsinr <= LOOP_SINR_ATOL_DB:
        raise AssertionError(f"loop parity: sinr_db differs by {max_dsinr} dB")
    if not retx_calls:
        raise AssertionError("loop parity: the 51-PRB run had no retransmission to take LLRs from")
    err, shapes = _kernel_equals_plain(retx_calls, "the 51-PRB loop's combined LLRs")
    print(f"loop 51 PRB x2 UEs: cuda vs cpu: RI/PMI/CQI/TPMI/MCS/rv/CRC equal over 6 DL + 2 UL "
          f"slots, TBs equal where the CRC passes, max |d sinr_db| {max_dsinr:.3g} dB; kernel "
          f"bit-equal to its plain version on the combined LLRs of {len(retx_calls)} "
          f"retransmission batches (bg, z, codewords) {shapes}", flush=True)
    return err


LOOP_READINGS = 3


def phase_loop_full(dev, n_slots=8):
    """Phase 6b: both loops at full width. First the kernel against its plain
    version on what the full-width receives hand it (untimed slots, new
    transmissions and combined retransmissions); then LOOP_READINGS timed
    windows of n_slots slots per direction, each with its gates. The noise of
    a timed window is drawn before it (the same numpy draw as in 6a)."""
    import numpy as np
    import torch

    from isac_tpu_torch.example import example_link_loop
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda

    t0 = time.perf_counter()
    loop = example_link_loop(device=dev)
    rng = np.random.default_rng(1)
    # untimed slots (they also bring the constants onto the device): every
    # decoder input of the full-width path, held against the plain version
    kernel_err, shapes = 0.0, {}
    with _recording_layered() as seen:
        loop.csi_report(rng)
        rvs = set()
        for _ in range(6):
            rvs |= {r["rv"] for r in loop.dl_slot(rng)}
            if len(rvs) > 1 and len(seen) >= 4:
                break
        if rvs == {0}:
            raise AssertionError("dl loop: the untimed slots had no retransmission round")
        n_dl = len(seen)
        loop.srs_report(rng)
        loop.ul_slot(rng)
    for what, calls in (("dl", seen[:n_dl]), ("ul", seen[n_dl:])):
        if not calls:
            raise AssertionError(f"{what} loop: no decoder input was recorded")
        err, shapes[what] = _kernel_equals_plain(calls, f"the 273-PRB {what} loop's LLRs")
        kernel_err = max(kernel_err, err)
    print(f"loop 273 PRB: kernel bit-equal to its plain version on the decoder inputs of "
          f"{n_dl} DL receives (rv seen {sorted(rvs)}) and {len(seen) - n_dl} UL receives, "
          f"(bg, z, codewords) dl {shapes['dl']} ul {shapes['ul']}", flush=True)
    del seen
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    res = {"setup_s": setup_s}

    def timed(call, n):
        """(event ms per call, host ms per call, results) of n calls of the
        loop's method `call`, with each call's noise drawn beforehand."""
        fn = getattr(loop, call)
        noises = [loop.draw_noise(rng, call) for _ in range(n)]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        outs = [fn(rng, noise=nz) for nz in noises]
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, (time.perf_counter() - t1) / n * 1e3, outs

    def report(call):
        reads = [timed(call, 4) for _ in range(LOOP_READINGS)]
        res[f"{call}_ms_readings"] = [r[0] for r in reads]
        res[f"{call}_host_ms_readings"] = [r[1] for r in reads]
        res[f"{call}_ms"] = sorted(r[0] for r in reads)[LOOP_READINGS // 2]
        return reads[-1][2][-1]

    rep = report("csi_report")
    res["dl_rank_cqi"] = [(r["rank"], int(r["cqi_sb"].min()), int(r["cqi_sb"].max())) for r in rep]
    launches = {}
    for direction in ("dl", "ul"):
        if direction == "ul":
            rep = report("srs_report")
            res["ul_rank_tpmi"] = [(r["rank"], r["tpmi"]) for r in rep]
        reads = []
        for _ in range(LOOP_READINGS):
            # a new HARQ epoch, so every window starts from new transmissions
            loop.harq[direction.upper()] = [None] * loop.n_ues
            calls0 = loop.rx_calls
            decode_layered_cuda.launches = 0
            ms, host_ms, outs = timed(f"{direction}_slot", n_slots)
            n_launch = decode_layered_cuda.launches
            rx_calls = loop.rx_calls - calls0
            recs = [r for o in outs for r in o]
            for r in recs:
                if r["crc_ok"] and not r["tb_equal"]:
                    raise AssertionError(f"{direction} loop: a CRC-passing TB differs from the sent one")
                if not np.isfinite(r["sinr_db"]):
                    raise AssertionError(f"{direction} loop: sinr_db not finite: {r}")
                if r["dropped"]:
                    raise AssertionError(f"{direction} loop: a TB ran out of the four RVs: {r}")
            if n_launch != rx_calls or rx_calls <= 0:
                raise AssertionError(f"{direction} loop: {n_launch} kernel launches for "
                                     f"{rx_calls} sch_receive_batch calls")
            by_rv = {rv: [sum(r["crc_ok"] for r in recs if r["rv"] == rv),
                          sum(1 for r in recs if r["rv"] == rv)] for rv in (0, 3, 2, 1)}
            if direction == "dl" and not by_rv[0][0] < by_rv[0][1]:
                raise AssertionError(f"dl loop: no grant failed at rv 0: {by_rv}")
            if direction == "dl" and sum(n for _, n in list(by_rv.values())[1:]) == 0:
                raise AssertionError(f"dl loop: no retransmission ran: {by_rv}")
            if direction == "ul" and not all(r["crc_ok"] for r in recs):
                raise AssertionError(f"ul loop: a grant failed: {by_rv}")
            tb_bits = sum(len(r["tb"]) for r in recs if r["crc_ok"])
            reads.append({"ms": ms, "host_ms": host_ms, "launches": n_launch, "rx_calls": rx_calls,
                          "goodput_mbps": tb_bits / n_slots / (ms / 1e3) / 1e6, "by_rv": by_rv,
                          "mcs_rank": sorted({(r["mcs"], r["rank"]) for r in recs}),
                          "sinr_db_last": [round(r["sinr_db"], 2) for r in outs[-1]]})
        # the launch count reported for the path is the first window's
        launches[direction] = reads[0]["launches"]
        mid = sorted(reads, key=lambda r: r["ms"])[LOOP_READINGS // 2]
        res.update({
            f"loop_{direction}_slot_ms": mid["ms"], f"loop_{direction}_host_slot_ms": mid["host_ms"],
            f"loop_{direction}_slot_ms_readings": [r["ms"] for r in reads],
            f"loop_{direction}_host_slot_ms_readings": [r["host_ms"] for r in reads],
            f"loop_{direction}_goodput_mbps": mid["goodput_mbps"],
            f"{direction}_crc_ok_of_sent_by_rv": [{str(k): v for k, v in r["by_rv"].items()}
                                                  for r in reads],
            f"{direction}_mcs_rank": reads[0]["mcs_rank"],
            f"{direction}_ldpc_layered_launches": [r["launches"] for r in reads],
            f"{direction}_sch_receive_batch_calls": [r["rx_calls"] for r in reads],
            f"{direction}_sinr_db_last": reads[-1]["sinr_db_last"],
        })
    res["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
    print("link loop 273 PRB x4 UEs, 16 gNB ports: " + json.dumps(res), flush=True)
    return res, launches, kernel_err


def phase_flooding(dev):
    """Phase 6c: the flooding schedule, card against CPU and against the
    layered kernel at half the iterations."""
    import numpy as np
    import torch

    from isac_tpu_torch.ops import transport
    from isac_tpu_torch.phy.chains import SCHGrant, _layout

    g = SCHGrant(n_prb=68, mcs=15, n_layers=2, n_sc_grid=3276)
    cfg = _layout(g.layout_key())["cfg"]
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 2, (4, cfg.a)).astype(np.int8)
    enc = transport.sch_encode(torch.as_tensor(tb), cfg, 0).numpy().astype(np.float64)
    sig = np.array([0.45, 0.45, 0.5, 1.4])  # the last grant does not decode
    y = (1.0 - 2.0 * enc) + sig[:, None] * rng.standard_normal(enc.shape)
    llr = (2.0 * y / sig[:, None] ** 2).astype(np.float32)
    llr_d = torch.as_tensor(llr, device=dev)
    tb_c, ok_c, _ = transport.sch_decode(torch.as_tensor(llr), cfg, 0, n_iter=12, schedule="flooding")
    t0 = time.perf_counter()
    tb_f, ok_f, _ = transport.sch_decode(llr_d, cfg, 0, n_iter=12, schedule="flooding")
    torch.cuda.synchronize()
    flood_ms = (time.perf_counter() - t0) * 1e3
    tb_l, ok_l, _ = transport.sch_decode(llr_d, cfg, 0, n_iter=6, schedule="layered")
    ok = ok_c.tolist()
    if not (ok_f.cpu().tolist() == ok == [True, True, True, False]):
        raise AssertionError(f"flooding: CRC flags card {ok_f.tolist()} cpu {ok}")
    if not torch.equal(tb_f.cpu()[ok_c], tb_c[ok_c]):
        raise AssertionError("flooding: TB bits differ between the card and the CPU")
    if not (ok_l.cpu().tolist() == ok and torch.equal(tb_l[ok_l], tb_f[ok_l])
            and np.array_equal(tb_f.cpu().numpy()[:3], tb[:3])):
        raise AssertionError(f"flooding at 12 iterations vs layered kernel at 6: flags "
                             f"{ok_l.tolist()} vs {ok}, or TBs differ")
    print(f"flooding BG{cfg.bg} Z={cfg.z} x{4 * cfg.c} code blocks: card vs cpu TB bits and CRC "
          f"flags equal {ok}; flooding x12 and the layered kernel x6 decode the same TBs; "
          f"first call on the card {flood_ms:.1f} ms by the host clock", flush=True)


# What the JAX engine (isac_tpu/sim/cell.py) does on the shipped
# open_street_map_city at full width, seed 0, on its CPU backend:
# `python tools/cell_reference_constants.py` (jax 0.9.0; PERF.md section 4).
# Its frame holds no retransmission (every CRC passes).
CELL_EXPECT = {
    "n_rb": 273, "nfft": 4096, "n_tx": 16, "n_ues": 5,
    "dl_tbs": [10, 12, 10, 10, 10], "dl_crc_fail": [0, 0, 0, 0, 0],
    "ul_tbs": [4, 4, 4, 4, 4], "ul_crc_fail": [0, 0, 0, 0, 0],
    "dl_mbps": [49.4808, 49.02, 49.4808, 50.2008, 48.3528],
    "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
    "detections": 1, "rngEst": [86.6099624633789], "velEst": [9.12436580657959],
    "aziEst": [-22.0],
}
CELL_THR_RTOL = 0.01
CELL_EST_TOL = {"rngEst": 0.5, "velEst": 0.5, "aziEst": 0.5}  # m, m/s, deg
CELL_READINGS = 3
GOLDEN_SINR_TOL_DB = 0.1


def _trace_key(t):
    return tuple(t[k] for k in ("slot", "dir", "ue", "mcs", "n_prb", "tbs", "crc", "rv"))


def phase_cell_golden(dev):
    """Phase 7a: the fixed-seed single link on the card and on the CPU, both
    against the committed golden trace and against each other."""
    from dataclasses import replace
    from pathlib import Path

    from isac_tpu_torch.config.params import SimulationParameters, assign_cell_parameters
    from isac_tpu_torch.config.scenarios import single_link
    from isac_tpu_torch.sim.cell import CellSimulator

    golden = json.loads((Path(__file__).resolve().parent / "tests" / "golden"
                         / "single_link_trace.json").read_text())
    cell = assign_cell_parameters(single_link(SimulationParameters()))[0]
    cell = replace(cell, log=replace(cell.log, enable_traces=True))
    traces = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        sim = CellSimulator(cell, seed=golden["seed"], n_rb_override=golden["n_rb"],
                            nfft_override=golden["nfft"], device=d)
        sim.run()
        tr = sim.metrics.trace
        if len(tr) != len(golden["trace"]):
            raise AssertionError(f"cell golden ({name}): {len(tr)} trace rows, expected "
                                 f"{len(golden['trace'])}")
        for got, exp in zip(tr, golden["trace"]):
            if _trace_key(got) != _trace_key(exp) or not (
                    abs(float(got["sinr_db"]) - exp["sinr_db"]) < GOLDEN_SINR_TOL_DB):
                raise AssertionError(f"cell golden ({name}): {got} vs {exp}")
        traces[name] = tr
    d_sinr = max(abs(float(a["sinr_db"]) - float(b["sinr_db"]))
                 for a, b in zip(traces["cuda"], traces["cpu"]))
    if not ([_trace_key(t) for t in traces["cuda"]] == [_trace_key(t) for t in traces["cpu"]]
            and d_sinr <= LOOP_SINR_ATOL_DB):
        raise AssertionError(f"cell golden: card and CPU traces differ (max |d sinr| {d_sinr})")
    print(f"cell golden single link 51 PRB / nfft 1024 / seed {golden['seed']}: card and CPU "
          f"reproduce the {len(golden['trace'])}-row golden trace (integer fields exact, SINR "
          f"within {GOLDEN_SINR_TOL_DB} dB); card vs CPU max |d sinr_db| {d_sinr:.3g} dB",
          flush=True)


def phase_cell_harq(dev):
    """Phase 7a, second part: the single link at 24 PRB / nfft 512 with the gNB
    at 10 dBm and the UE at -35 dBm, so that blocks fail in both directions
    and their rv-3 retransmissions pass on the combined soft buffers. Card and
    CPU traces agree, and on the card a checkpoint at slot 10 (soft buffers
    waiting, pickled as numpy) resumes to the straight run."""
    import pickle
    from dataclasses import replace

    from isac_tpu_torch.config.params import SimulationParameters, assign_cell_parameters
    from isac_tpu_torch.config.scenarios import single_link
    from isac_tpu_torch.sim.cell import CellSimulator

    cell = assign_cell_parameters(single_link(SimulationParameters()))[0]
    cell = replace(cell, log=replace(cell.log, enable_traces=True),
                   gnb=replace(cell.gnb, tx_power_dbm=10.0), ue=replace(cell.ue, tx_power_dbm=-35.0))

    def engine(d):
        return CellSimulator(cell, n_rb_override=24, nfft_override=512, device=d)

    traces = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        sim = engine(d)
        sim.run()
        traces[name] = sim.metrics.trace
    tr = traces["cuda"]
    for d in ("DL", "UL"):
        if not any(t["rv"] != 0 and t["crc"] for t in tr if t["dir"] == d):
            raise AssertionError(f"cell HARQ: no passing {d} retransmission in {tr}")
    d_sinr = max(abs(float(a["sinr_db"]) - float(b["sinr_db"]))
                 for a, b in zip(tr, traces["cpu"]))
    if not (len(tr) == len(traces["cpu"])
            and [_trace_key(t) for t in tr] == [_trace_key(t) for t in traces["cpu"]]
            and d_sinr <= LOOP_SINR_ATOL_DB):
        raise AssertionError(f"cell HARQ: card and CPU traces differ (max |d sinr| {d_sinr})")
    first = engine(dev)
    first.run(stop_slot=10, finalize=False)
    n_bufs = len(first.rx_soft_bufs)
    if n_bufs == 0:
        raise AssertionError("cell HARQ: no soft buffer waits at the checkpoint")
    second = engine(dev)
    second.run(start_slot=second.restore(pickle.loads(pickle.dumps(first.checkpoint(10)))))
    if second.metrics.trace != tr:
        raise AssertionError("cell HARQ: the resumed card run differs from the straight one")
    n_retx = sum(1 for t in tr if t["rv"] != 0)
    print(f"cell HARQ single link 24 PRB: {n_retx} retransmissions after "
          f"{sum(1 for t in tr if not t['crc'])} failed blocks, card and CPU traces equal "
          f"(max |d sinr_db| {d_sinr:.3g} dB); checkpoint at slot 10 with {n_bufs} soft "
          f"buffers resumed to the straight card run", flush=True)


def _result_outcome(res):
    """What a result dict carries: per-UE BLER and throughputs, and the
    detections when it holds a sensing result."""
    import numpy as np

    comm = res["communication"]
    out = {k: [float(x) for x in comm[key]] for k, key in (
        ("dl_bler", "ueDLBLER"), ("ul_bler", "ueULBLER"),
        ("dl_mbps", "ueDLThroughputMbps"), ("ul_mbps", "ueULThroughputMbps"))}
    if res["sensing"] is not None:
        est = res["sensing"]["estimates"]
        out["detections"] = int(est["valid"].sum())
        for k in CELL_EST_TOL:
            v = est[k].cpu().numpy().astype(np.float64)
            out[k] = [float(x) for x in v[np.isfinite(v)]]
    return out


def _cell_outcome(sim, res):
    """Per-UE counters of one engine run, and what its result dict carries."""
    return {"dl_tbs": [c.blk_total for c in sim.metrics.dl],
            "dl_crc_fail": [c.blk_err for c in sim.metrics.dl],
            "ul_tbs": [c.blk_total for c in sim.metrics.ul],
            "ul_crc_fail": [c.blk_err for c in sim.metrics.ul],
            **_result_outcome(res)}


def _check_against(out, exp, what):
    """Every outcome that `exp` states, held against `out`, or AssertionError:
    counts, BLERs and detections exact, throughputs within CELL_THR_RTOL,
    estimates within CELL_EST_TOL."""
    import numpy as np

    for k, want in exp.items():
        if k in ("n_rb", "nfft", "n_tx", "n_ues", "ue_los"):  # configuration
            continue
        if k not in out:
            raise AssertionError(f"{what}: the run gives no {k} to hold against {want}")
        v = out[k]
        if k in ("dl_mbps", "ul_mbps"):
            ok = np.allclose(v, want, rtol=CELL_THR_RTOL, atol=0)
        elif k in CELL_EST_TOL:
            ok = len(v) == len(want) and bool(np.all(np.abs(np.subtract(v, want))
                                                     <= CELL_EST_TOL[k]))
        else:
            ok = v == want
        if not ok:
            raise AssertionError(f"{what}: {k} {v}, the JAX package's {want}")


def phase_cell_full(dev):
    """Phase 7b: the shipped scenario at full width through the engine's
    public entry points. Returns (result dict, launches of one frame, max
    kernel error)."""
    import numpy as np
    import torch

    from isac_tpu_torch.example import example_cell
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda

    t0 = time.perf_counter()
    sim = example_cell(device=dev, traces=True)
    if (sim.n_rb, sim.info.nfft, sim.n_tx, sim.n_ues) != tuple(
            CELL_EXPECT[k] for k in ("n_rb", "nfft", "n_tx", "n_ues")):
        raise AssertionError(f"cell: {sim.n_rb} PRB, nfft {sim.info.nfft}, {sim.n_tx} ports, "
                             f"{sim.n_ues} UEs")
    with _recording_layered() as seen, _counting_draws(program_counts=True) as drawn:
        res = sim.run()
    untimed_draws = _held_draws(drawn, 1, "cell untimed frame")
    retx = sum(1 for t in sim.metrics.trace if t["rv"] != 0)
    _check_against(_cell_outcome(sim, res), CELL_EXPECT, "cell untimed frame")
    kernel_err, shapes = _kernel_equals_plain(seen, "the 273-PRB cell frame's LLRs")
    print(f"cell 273 PRB untimed frame: kernel bit-equal to its plain version on all {len(seen)} "
          f"decoder inputs of {sim.rx_calls} receives, (bg, z, codewords) {shapes}; "
          + ("the frame holds no retransmission (every CRC passes)" if retx == 0 else
             f"{retx} of the frame's transmissions are retransmissions"), flush=True)
    del seen
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reads = []
    for _ in range(CELL_READINGS):
        sim = example_cell(device=dev)
        torch.cuda.synchronize()
        decode_layered_cuda.launches = 0
        with _counting_draws() as drawn:
            t1 = time.perf_counter()
            sim.run(finalize=False)
            torch.cuda.synchronize()
            slot_ms = (time.perf_counter() - t1) * 1e3 / sim.num_slots
            launches = decode_layered_cuda.launches
            rx_calls = sim.rx_calls
            res = sim.finalize(sensing=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res["sensing"] = sim.run_sensing()
            torch.cuda.synchronize()
            sensing_ms = (time.perf_counter() - t1) * 1e3
        if launches != rx_calls or rx_calls <= 0:
            raise AssertionError(f"cell: {launches} kernel launches for {rx_calls} "
                                 f"sch_receive_batch calls")
        draws = _held_draws(drawn, 1, f"cell timed frame {len(reads)}")
        out = _cell_outcome(sim, res)
        _check_against(out, CELL_EXPECT, f"cell timed frame {len(reads)}")
        reads.append({"cell_slot_ms": slot_ms, "cell_sensing_ms": sensing_ms,
                      "ldpc_layered_launches": launches, "sch_receive_batch_calls": rx_calls,
                      "threefry": draws, **out})
        print(f"cell 273 PRB timed frame {len(reads) - 1}: " + json.dumps(reads[-1]), flush=True)
    mid = CELL_READINGS // 2
    result = {
        "cell_slot_ms": sorted(r["cell_slot_ms"] for r in reads)[mid],
        "cell_sensing_ms": sorted(r["cell_sensing_ms"] for r in reads)[mid],
        "cell_slot_ms_readings": [r["cell_slot_ms"] for r in reads],
        "cell_sensing_ms_readings": [r["cell_sensing_ms"] for r in reads],
        "ldpc_layered_launches_per_frame": [r["ldpc_layered_launches"] for r in reads],
        "sch_receive_batch_calls_per_frame": [r["sch_receive_batch_calls"] for r in reads],
        "threefry_untimed": untimed_draws, "threefry": reads[0]["threefry"],
        "slots": sim.num_slots, "setup_s": setup_s,
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
        "est_err_vs_jax": {k: max(float(np.max(np.abs(np.subtract(r[k], CELL_EXPECT[k]))))
                                  for r in reads) for k in CELL_EST_TOL},
    }
    print("cell 273 PRB x16 ports x5 UEs, one frame (open_street_map_city as shipped), "
          "medians: " + json.dumps(result), flush=True)
    return result, reads[0]["ldpc_layered_launches"], kernel_err


# What the JAX package does at the top-level entry and in the 2-cell network
# at full width, seed 0, on its CPU backend:
# `PYTHONPATH=. python tools/network_reference_constants.py` (jax 0.9.0;
# PERF.md section 4). The city leaves 4 of cell 1's 5 UEs (and every cross
# link) in NLoS.
CITY_EXPECT = {
    "n_rb": 273, "nfft": 4096, "n_tx": 16, "n_ues": 5,
    "ue_los": [False, False, False, False, True],
    "dl_bler": [0.0, 0.0, 0.0, 0.1, 0.0], "ul_bler": [0.0, 0.0, 0.0, 0.0, 0.0],
    "dl_mbps": [48.6592, 48.6568, 46.512, 49.9952, 48.1472],
    "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
    "detections": 1, "rngEst": [86.6099624633789], "velEst": [9.12436580657959],
    "aziEst": [-22.0],
}
NETWORK_EXPECT = {
    "num_cells": 2, "n_rb": 273, "nfft": 4096,
    "cross_los": {(0, 1): [False] * 5, (1, 0): [False] * 5},
    "cells": [
        {"ue_los": [False, False, False, False, True],
         "dl_tbs": [10, 11, 10, 11, 10], "dl_crc_fail": [2, 3, 1, 3, 0],
         "ul_tbs": [4, 4, 4, 4, 4], "ul_crc_fail": [0, 0, 0, 0, 0],
         "dl_mbps": [49.8864, 51.6304, 46.0552, 52.1568, 48.1472],
         "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
         "detections": 1, "rngEst": [86.6099624633789], "velEst": [9.12436580657959],
         "aziEst": [-22.0]},
        {"ue_los": [False, True, True, True, False],
         "dl_tbs": [11, 12, 10, 10, 11], "dl_crc_fail": [2, 0, 0, 0, 3],
         "ul_tbs": [4, 4, 4, 4, 4], "ul_crc_fail": [0, 0, 0, 0, 0],
         "dl_mbps": [51.9384, 49.02, 49.4808, 50.2008, 54.1912],
         "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
         "detections": 1, "rngEst": [123.20572662353516], "velEst": [4.562182903289795],
         "aziEst": [18.0]},
    ],
}
NETWORK_READINGS = 3


def _network_outcome(runner, results):
    """_cell_outcome of every cell of a network run."""
    return [_cell_outcome(sim, res) for sim, res in zip(runner.sims, results)]


def phase_network_parity(dev):
    """Phase 8a: two co-channel cells at 24 PRB, card against CPU, with the
    DL cross term seen non-zero in each cell."""
    from isac_tpu_torch.example import example_network

    traces, ext_slots = {}, {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        runner = example_network(n_rb=24, nfft=512, traces=True, device=d)
        seen = [0] * len(runner.sims)
        dl_ext = runner._dl_ext

        def counting(cell, slot, states, dl_ext=dl_ext, seen=seen):
            ext = dl_ext(cell, slot, states)
            if ext is not None and bool(ext.abs().amax() > 0):
                seen[cell] += 1
            return ext

        runner._dl_ext = counting
        runner.run()
        traces[name] = [sim.metrics.trace for sim in runner.sims]
        ext_slots[name] = seen
    d_sinr = 0.0
    for c, (tg, tc) in enumerate(zip(traces["cuda"], traces["cpu"])):
        if not (len(tg) == len(tc) > 0
                and [_trace_key(t) for t in tg] == [_trace_key(t) for t in tc]):
            raise AssertionError(f"network 24 PRB cell {c}: card and CPU traces differ")
        d_sinr = max([d_sinr] + [abs(float(a["sinr_db"]) - float(b["sinr_db"]))
                                 for a, b in zip(tg, tc)])
    if not d_sinr <= LOOP_SINR_ATOL_DB:
        raise AssertionError(f"network 24 PRB: card and CPU SINR differ by {d_sinr} dB")
    if not all(n > 0 for n in ext_slots["cuda"]):
        raise AssertionError(f"network 24 PRB: DL cross term non-zero in {ext_slots['cuda']} "
                             f"slots per cell")
    fails = [sum(1 for t in tr if not t["crc"]) for tr in traces["cuda"]]
    print(f"network 24 PRB x2 cells: card and CPU traces equal ({[len(t) for t in traces['cuda']]} "
          f"rows, failed blocks {fails}), max |d sinr_db| {d_sinr:.3g} dB; DL cross term "
          f"non-zero in {ext_slots['cuda']} slots per cell", flush=True)


def phase_city_entry(dev):
    """Phase 8b: the README's quick start, simulate(open_street_map_city),
    at full width on the card, against the JAX package's numbers."""
    import torch

    from isac_tpu_torch.api import simulate
    from isac_tpu_torch.config.params import SimulationParameters, assign_cell_parameters
    from isac_tpu_torch.config.scenarios import open_street_map_city
    from isac_tpu_torch.sim.network import resolve_los

    sim = open_street_map_city(SimulationParameters())
    cell = resolve_los(assign_cell_parameters(sim), sim)[0]
    if cell.ue_los.tolist() != CITY_EXPECT["ue_los"]:
        raise AssertionError(f"city entry: UE LoS {cell.ue_los.tolist()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(open_street_map_city, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = _result_outcome(res["cells"][0])
    _check_against(out, CITY_EXPECT, "city entry")
    print(f"city entry simulate(open_street_map_city) 273 PRB, UE LoS {CITY_EXPECT['ue_los']}: "
          f"{secs:.1f} s with sensing, the JAX package's numbers: " + json.dumps(out), flush=True)


def phase_network_full(dev):
    """Phase 8c: two co-channel cells at 273 PRB. Returns (result dict,
    launches of the first timed frame, max kernel error)."""
    import torch

    from isac_tpu_torch.example import example_network

    t0 = time.perf_counter()
    runner = example_network(device=dev, traces=True)
    s0 = runner.sims[0]
    if (len(runner.sims), s0.n_rb, s0.info.nfft) != tuple(
            NETWORK_EXPECT[k] for k in ("num_cells", "n_rb", "nfft")):
        raise AssertionError(f"network: {len(runner.sims)} cells, {s0.n_rb} PRB")
    for sim, exp in zip(runner.sims, NETWORK_EXPECT["cells"]):
        if sim.cell.ue_los.tolist() != exp["ue_los"]:
            raise AssertionError(f"network: UE LoS {sim.cell.ue_los.tolist()}")
    if {k: v.tolist() for k, v in runner.cross_los.items()} != NETWORK_EXPECT["cross_los"]:
        raise AssertionError(f"network: cross LoS {runner.cross_los}")
    torch.cuda.reset_peak_memory_stats()
    with _recording_layered() as seen, _counting_draws(program_counts=True) as drawn:
        results = runner.run()
    untimed_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    untimed_draws = _held_draws(drawn, len(runner.sims), "network untimed frame")
    outs = _network_outcome(runner, results)
    for c, (out, exp) in enumerate(zip(outs, NETWORK_EXPECT["cells"])):
        _check_against(out, exp, f"network untimed frame cell {c}")
    kernel_err, shapes = _kernel_equals_plain(seen, "the 273-PRB network frame's LLRs")
    retx = [sum(1 for t in sim.metrics.trace if t["rv"] != 0) for sim in runner.sims]
    print(f"network 273 PRB x2 cells untimed frame (sensing on): the JAX network's counts "
          f"(failed DL blocks {[sum(o['dl_crc_fail']) for o in outs]}, retransmissions {retx}) "
          f"and detections; kernel bit-equal to its plain version on all {len(seen)} decoder "
          f"inputs of {sum(s.rx_calls for s in runner.sims)} receives, (bg, z, codewords) "
          f"{shapes}; peak memory {untimed_peak_mb:.0f} MB", flush=True)
    del seen, runner, results
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    result, launches = _timed_network_frames(dev, 2, NETWORK_EXPECT["cells"], "network")
    result.update(untimed_peak_memory_mb=untimed_peak_mb, setup_s=setup_s,
                  threefry_untimed=untimed_draws)
    print("network 273 PRB x16 ports x2 cells x5 UEs, one frame, DL + UL interference, "
          "medians: " + json.dumps(result), flush=True)
    return result, launches, kernel_err


NETWORK_COUNT_KEYS = ("dl_tbs", "dl_crc_fail", "ul_tbs", "ul_crc_fail", "dl_mbps", "ul_mbps")


def _timed_network_frames(dev, num_cells, exp_cells, metric):
    """NETWORK_READINGS frames of example_network(num_cells) without sensing,
    each on a fresh runner of seed 0 and timed on the host clock after
    synchronize (the bank build, which run() would do lazily, inside the
    frame and also timed on its own), each held to the counts of `exp_cells`,
    with kernel launches = sch_receive_batch calls. Returns (medians and
    readings named after `metric`, kernel launches of the first frame)."""
    import torch

    from isac_tpu_torch.example import example_network
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda

    reads = []
    for _ in range(NETWORK_READINGS):
        runner = example_network(num_cells=num_cells, device=dev, sensing=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_layered_cuda.launches = 0
        with _counting_draws() as drawn:
            t1 = time.perf_counter()
            runner._build_banks()
            torch.cuda.synchronize()
            bank_s = time.perf_counter() - t1
            results = runner.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        launches = decode_layered_cuda.launches
        rx_calls = sum(s.rx_calls for s in runner.sims)
        if launches != rx_calls or rx_calls <= 0:
            raise AssertionError(f"{metric}: {launches} kernel launches for {rx_calls} "
                                 f"sch_receive_batch calls")
        draws = _held_draws(drawn, 0, f"{metric} timed frame {len(reads)}")
        outs = _network_outcome(runner, results)
        for c, (out, exp) in enumerate(zip(outs, exp_cells)):
            _check_against(out, {k: exp[k] for k in NETWORK_COUNT_KEYS},
                           f"{metric} timed frame {len(reads)} cell {c}")
        n = runner.num_slots
        reads.append({
            f"{metric}_frame_s": secs, f"{metric}_slot_ms": secs * 1e3 / n,
            f"{metric}_cell_slots_per_s": num_cells * n / secs, "bank_build_s": bank_s,
            "ldpc_layered_launches": launches, "sch_receive_batch_calls": rx_calls,
            "threefry": draws, "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
            "stage_host_ms_per_slot": {k: round(v * 1e3 / n, 3)
                                       for k, v in runner.stage_s.items()},
            "dl_crc_fail": [sum(o["dl_crc_fail"]) for o in outs],
        })
        print(f"{metric} 273 PRB x{num_cells} cells timed frame {len(reads) - 1}: "
              + json.dumps(reads[-1]), flush=True)
        del runner, results
        torch.cuda.empty_cache()
    mid = sorted(reads, key=lambda r: r[f"{metric}_frame_s"])[NETWORK_READINGS // 2]
    return {
        f"{metric}_slot_ms": mid[f"{metric}_slot_ms"],
        f"{metric}_cell_slots_per_s": mid[f"{metric}_cell_slots_per_s"],
        f"{metric}_slot_ms_readings": [r[f"{metric}_slot_ms"] for r in reads],
        f"{metric}_cell_slots_per_s_readings": [r[f"{metric}_cell_slots_per_s"] for r in reads],
        "stage_host_ms_per_slot": mid["stage_host_ms_per_slot"],
        "bank_build_s_readings": [r["bank_build_s"] for r in reads],
        "ldpc_layered_launches_per_frame": [r["ldpc_layered_launches"] for r in reads],
        "threefry": reads[0]["threefry"],
        "peak_memory_mb": max(r["peak_memory_mb"] for r in reads),
    }, reads[0]["ldpc_layered_launches"]


# What the JAX package does in the 7-cell network at full width, seed 0, on
# its CPU backend: `PYTHONPATH=. python tools/network_reference_constants.py
# --num-cells 7` (jax 0.9.0; PERF.md section 4). Cross links not listed are
# NLoS for every UE.
NETWORK7_EXPECT = {
    "num_cells": 7, "n_rb": 273, "nfft": 4096, "n_tx": 16, "n_ues": 5,
    "cross_los": {},
    "cells": [
        {"ue_los": [False, False, False, False, True],
         "dl_tbs": [12, 14, 11, 11, 10],
         "dl_crc_fail": [7, 4, 9, 7, 0],
         "ul_tbs": [4, 4, 5, 5, 4],
         "ul_crc_fail": [0, 0, 1, 1, 0],
         "dl_mbps": [55.784, 64.0728, 53.7936, 71.8272, 48.1472],
         "ul_mbps": [8.5264, 8.5264, 10.8832, 10.8832, 6.5328],
         "valid": [True, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [86.6099624633789, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "velEst": [9.12436580657959, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "aziEst": [-22.0, None, None, None]},
        {"ue_los": [False, True, True, True, False],
         "dl_tbs": [10, 12, 10, 10, 12],
         "dl_crc_fail": [3, 1, 0, 1, 4],
         "ul_tbs": [4, 4, 4, 4, 4],
         "ul_crc_fail": [0, 0, 0, 0, 0],
         "dl_mbps": [53.5816, 50.4576, 49.4808, 50.2008, 54.092],
         "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
         "valid": [True, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [123.20572662353516, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "velEst": [4.562182903289795, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "aziEst": [18.0, None, None, None]},
        {"ue_los": [False, False, False, True, False],
         "dl_tbs": [12, 12, 11, 12, 12],
         "dl_crc_fail": [6, 1, 4, 3, 3],
         "ul_tbs": [4, 4, 4, 4, 4],
         "ul_crc_fail": [0, 0, 0, 0, 0],
         "dl_mbps": [55.548, 53.3264, 60.1664, 69.06, 54.9576],
         "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
         "valid": [False, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [None, None, None, None, None, None, None, None, None, None, None, None, None,
                   None, None, None],
         "velEst": [None, None, None, None, None, None, None, None, None, None, None, None, None,
                   None, None, None],
         "aziEst": [-68.0, None, None, None]},
        {"ue_los": [False, True, True, True, True],
         "dl_tbs": [12, 12, 10, 12, 10],
         "dl_crc_fail": [8, 1, 0, 4, 0],
         "ul_tbs": [4, 4, 4, 4, 4],
         "ul_crc_fail": [0, 0, 0, 0, 0],
         "dl_mbps": [61.9824, 47.2176, 49.4808, 60.9856, 48.3528],
         "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
         "valid": [True, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [136.62417602539062, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "velEst": [4.562182903289795, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "aziEst": [-56.0, None, None, None]},
        {"ue_los": [False, False, False, True, False],
         "dl_tbs": [13, 12, 10, 9, 10],
         "dl_crc_fail": [10, 1, 4, 2, 6],
         "ul_tbs": [5, 4, 5, 4, 5],
         "ul_crc_fail": [1, 0, 2, 0, 2],
         "dl_mbps": [54.4992, 53.5744, 43.9072, 49.3832, 34.1544],
         "ul_mbps": [10.8832, 8.5264, 10.4248, 8.5264, 8.8896],
         "valid": [False, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [None, None, None, None, None, None, None, None, None, None, None, None, None,
                   None, None, None],
         "velEst": [None, None, None, None, None, None, None, None, None, None, None, None, None,
                   None, None, None],
         "aziEst": [17.0, None, None, None]},
        {"ue_los": [False, False, False, False, False],
         "dl_tbs": [13, 13, 9, 10, 12],
         "dl_crc_fail": [6, 1, 3, 0, 3],
         "ul_tbs": [5, 4, 4, 4, 4],
         "ul_crc_fail": [3, 0, 0, 0, 0],
         "dl_mbps": [51.26, 51.2688, 44.8208, 50.2008, 54.296],
         "ul_mbps": [10.4248, 8.5264, 8.5264, 8.5264, 6.5328],
         "valid": [False, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [None, None, None, None, None, None, None, None, None, None, None, None, None,
                   None, None, None],
         "velEst": [None, None, None, None, None, None, None, None, None, None, None, None, None,
                   None, None, None],
         "aziEst": [-61.0, None, None, None]},
        {"ue_los": [True, False, True, True, True],
         "dl_tbs": [10, 13, 10, 11, 10],
         "dl_crc_fail": [0, 1, 0, 1, 0],
         "ul_tbs": [4, 4, 4, 4, 4],
         "ul_crc_fail": [0, 0, 0, 0, 0],
         "dl_mbps": [49.4808, 51.4776, 49.4808, 52.6584, 48.3528],
         "ul_mbps": [8.5264, 8.5264, 8.5264, 8.5264, 6.5328],
         "valid": [True, False, False, False, False, False, False, False, False, False, False,
                  False, False, False, False, False],
         "doa_valid": [True, False, False, False],
         "rngEst": [154.9220428466797, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "velEst": [4.562182903289795, None, None, None, None, None, None, None, None, None, None,
                   None, None, None, None, None],
         "aziEst": [-5.0, None, None, None]},
    ],
}
# The split of Ra's eigenvalues at j is clean when (lam_j - lam_{j+1}) / lam_1
# >= SPLIT_TAU (tests/test_torch_network.py): MUSIC's peaks after the last
# clean split within the signal count depend on the basis that the
# eigensolver returns for a cluster of noise eigenvalues equal to rounding.
SPLIT_TAU = 1e-4


@contextlib.contextmanager
def _recording_music():
    """Within the block, the covariance of every call of the port's MUSIC DoA
    is kept (as complex128 numpy) in the yielded list, in call order."""
    import numpy as np

    from isac_tpu_torch.ops import sensing

    seen = []
    real = sensing.music_doa

    def recorder(ra, params, **kw):
        seen.append(ra.detach().cpu().numpy().astype(np.complex128))
        return real(ra, params, **kw)

    sensing.music_doa = recorder
    try:
        yield seen
    finally:
        sensing.music_doa = real


def _clean_signal_count(ra, n_sig):
    """The largest j <= n_sig whose eigenvalue split of `ra` is clean, or 0."""
    import numpy as np

    lam = np.linalg.eigvalsh(ra)[::-1]
    gaps = (lam[:-1] - lam[1:]) / lam[0]
    return max((j for j in range(1, n_sig + 1) if gaps[j - 1] >= SPLIT_TAU), default=0)


def _check_split_rule(est, ra, exp, what):
    """One cell's detections against the JAX package's under the split rule:
    valid and doa_valid exact, ranges and velocities within CELL_EST_TOL, the
    first m azimuths within CELL_EST_TOL, the next n - m finite where
    doa_valid is set, the rest NaN in both. Returns (m, n)."""
    import numpy as np

    got = {k: est[k].cpu().numpy() for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst")}
    want = {k: np.asarray([np.nan if x is None else x for x in exp[k]], np.float64)
            for k in ("rngEst", "velEst", "aziEst")}
    for k in ("valid", "doa_valid"):
        if got[k].tolist() != exp[k]:
            raise AssertionError(f"{what}: {k} {got[k].tolist()}, the JAX package's {exp[k]}")
    n = int(np.clip(got["valid"].sum(), 1, len(got["aziEst"])))
    m = _clean_signal_count(ra, n)

    def close(k, sl):
        g, w = got[k][sl].astype(np.float64), want[k][sl]
        return (np.array_equal(np.isnan(g), np.isnan(w))
                and bool(np.all(np.abs(g - w)[~np.isnan(w)] <= CELL_EST_TOL[k])))

    doa = got["doa_valid"][m:n]
    ok = (close("rngEst", slice(None)) and close("velEst", slice(None))
          and close("aziEst", slice(0, m)) and close("aziEst", slice(n, None))
          and np.isfinite(got["aziEst"][m:n][doa]).all())
    if not ok:
        raise AssertionError(f"{what}: detections {got}, the JAX package's {exp} "
                             f"(m {m} of n {n})")
    return m, n


def phase_network7(dev):
    """Phase 10: seven co-channel cells at 273 PRB. Returns the LDPC
    kernel's launches of the first timed frame, the max kernel error and the
    threefry kernel's counts of that frame."""
    import torch

    from isac_tpu_torch.example import example_network

    exp = NETWORK7_EXPECT
    t0 = time.perf_counter()
    runner = example_network(num_cells=7, device=dev, traces=True)
    s0 = runner.sims[0]
    if (len(runner.sims), s0.n_rb, s0.info.nfft, s0.n_tx, s0.n_ues) != tuple(
            exp[k] for k in ("num_cells", "n_rb", "nfft", "n_tx", "n_ues")):
        raise AssertionError(f"network7: {len(runner.sims)} cells, {s0.n_rb} PRB, "
                             f"nfft {s0.info.nfft}, {s0.n_tx} ports, {s0.n_ues} UEs")
    for c, (sim, e) in enumerate(zip(runner.sims, exp["cells"])):
        if sim.cell.ue_los.tolist() != e["ue_los"]:
            raise AssertionError(f"network7 cell {c}: UE LoS {sim.cell.ue_los.tolist()}")
    want_cross = {(d, s): exp["cross_los"].get((d, s), [False] * s0.n_ues)
                  for d in range(7) for s in range(7) if d != s}
    if {k: v.tolist() for k, v in runner.cross_los.items()} != want_cross:
        raise AssertionError(f"network7: cross LoS {runner.cross_los}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    runner._build_banks()
    torch.cuda.synchronize()
    bank_build_s = time.perf_counter() - t1
    with (_recording_layered() as seen, _recording_music() as ras,
          _counting_draws(program_counts=True) as drawn):
        results = runner.run()
    untimed_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    untimed_draws = _held_draws(drawn, 7, "network7 untimed frame")
    if len(ras) != 7:
        raise AssertionError(f"network7: {len(ras)} MUSIC calls for 7 cells")
    splits = []
    for c, (sim, res, e, ra) in enumerate(zip(runner.sims, results, exp["cells"], ras)):
        _check_against(_cell_outcome(sim, res), {k: e[k] for k in NETWORK_COUNT_KEYS},
                       f"network7 untimed frame cell {c}")
        splits.append(_check_split_rule(res["sensing"]["estimates"], ra, e,
                                        f"network7 untimed frame cell {c}"))
    kernel_err, shapes = _kernel_equals_plain(seen, "the 7-cell 273-PRB network frame's LLRs")
    fails = [sum(c.blk_err for c in sim.metrics.dl) for sim in runner.sims]
    retx = [sum(1 for t in sim.metrics.trace if t["rv"] != 0) for sim in runner.sims]
    print(f"network7 273 PRB x7 cells untimed frame (sensing on): the JAX network's counts "
          f"(failed DL blocks {fails}, retransmissions {retx}), cross LoS map exact, "
          f"detections under the split rule (m, n per cell {splits}); kernel bit-equal to its "
          f"plain version on all {len(seen)} decoder inputs of "
          f"{sum(s.rx_calls for s in runner.sims)} receives, (bg, z, codewords) {shapes}; "
          f"bank build {bank_build_s:.2f} s; peak memory {untimed_peak_mb:.0f} MB", flush=True)
    del seen, ras, runner, results
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    result, launches = _timed_network_frames(dev, 7, exp["cells"], "network7")
    result.update(untimed_bank_build_s=bank_build_s, untimed_peak_memory_mb=untimed_peak_mb,
                  setup_s=setup_s, card=_smi_line(), threefry_untimed=untimed_draws)
    print("network7 273 PRB x16 ports x7 cells x5 UEs, one frame, DL + UL interference, "
          "medians: " + json.dumps(result), flush=True)
    return launches, kernel_err, result["threefry"]


# Float tolerances for a result surface that two slot-loop frames of one seed
# already give differently on the card (none is expected: the path has no
# atomic float reduction); every other leaf of the result must be exact.
SEGMENT_FLOAT_TOL = {"sinr_db": LOOP_SINR_ATOL_DB, "rdm": SENSING_RDM_TOL,
                     "Throughput": CELL_THR_RTOL, "Goodput": CELL_THR_RTOL, **CELL_EST_TOL}
BLOCK_READINGS = 3


def _result_leaves(res) -> dict:
    """{path: host value} of every leaf of an engine result (the sensing
    params left out: host dataclasses, equal by construction)."""
    import numpy as np
    import torch

    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k in x:
                if not (path == ".sensing" and k == "params"):
                    walk(x[k], f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = x.detach().cpu().numpy() if torch.is_tensor(x) else (
                x if x is None or isinstance(x, str) else np.asarray(x))

    walk(res, "")
    return out


def _differing(a: dict, b: dict) -> dict:
    """{path: max |a - b|} of the leaves where two results differ; raises if
    they differ in structure, or in an integer, flag, string or log entry."""
    import numpy as np

    if a.keys() != b.keys():
        raise AssertionError(f"result structure differs: {sorted(a.keys() ^ b.keys())[:5]}")
    out = {}
    for k, x in a.items():
        y = b[k]
        if x is None or isinstance(x, str):
            if x != y:
                raise AssertionError(f"{k}: {x!r} vs {y!r}")
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{k}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}")
        if np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"):
            continue
        if x.dtype.kind not in "fc" or ".logs." in k:
            raise AssertionError(f"{k}: exact surface differs")
        out[k] = float(np.nanmax(np.abs(x.astype(np.complex128) - y.astype(np.complex128))))
    return out


def _within_float_tol(path: str, a, b) -> bool:
    import numpy as np

    key = next((k for k in SEGMENT_FLOAT_TOL if k in path.rsplit(".", 1)[-1]), None)
    if key is None:
        return False
    tol, d = SEGMENT_FLOAT_TOL[key], np.abs(a.astype(np.complex128) - b.astype(np.complex128))
    if key == "rdm":
        return bool(np.nanmax(d) <= tol * np.abs(a).max())
    if key in ("Throughput", "Goodput"):
        return bool(np.allclose(b, a, rtol=tol, atol=0, equal_nan=True))
    return bool(np.nanmax(d) <= tol)


# The profiler's runtime events of a kernel launch. The profiler can tie one
# to a copy that an op made elsewhere: at full width the LDPC kernel's
# cudaLaunchKernel inside a segment listed a device-to-host copy, and not its
# own kernel, while the op outside that made the copy listed it too. A launch
# makes no copy, so these events are never counted as a copy's source; the
# copy is still counted once, by its op.
_LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _segment_copies(prof) -> dict:
    """Device copies by direction, launched from inside and outside the
    `cell.segment` ranges of a profiled run (a copy is attributed to the
    host op that issued it)."""
    from torch.autograd import DeviceType

    events = prof.events()
    segs = [(e.time_range.start, e.time_range.end) for e in events
            if e.name == "cell.segment" and e.device_type == DeviceType.CPU]
    out = {"segments": len(segs), "d2h_in": 0, "h2d_in": 0, "d2h_out": 0, "h2d_out": 0,
           "d2h_ops_in": [], "d2h_device_events": 0}
    for e in events:
        if e.device_type != DeviceType.CPU:
            out["d2h_device_events"] += "DtoH" in e.name
            continue
        if e.name in _LAUNCH_EVENTS:
            continue
        inside = any(a <= e.time_range.start and e.time_range.end <= b for a, b in segs)
        for k in e.kernels:
            for d in ("d2h", "h2d"):
                if ("DtoH" if d == "d2h" else "HtoD") in k.name:
                    out[f"{d}_{'in' if inside else 'out'}"] += 1
                    if d == "d2h" and inside:
                        out["d2h_ops_in"].append(e.name)
    return out


def phase_block_mode(dev, cell_slot_ms):
    """Phase 9a: block mode (CellSimulator(block_slots=)) at full width
    against the slot loop, its device-to-host copies inside segments, and
    its slot time. Returns the LDPC kernel's launches of the first timed
    frame and the threefry kernel's counts of that frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from isac_tpu_torch.example import example_cell
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda

    def frame(block_slots, profiled=False):
        sim = example_cell(device=dev, traces=True, block_slots=block_slots)
        torch.cuda.synchronize()
        decode_layered_cuda.launches = 0
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
               else contextlib.nullcontext())
        with ctx as prof, _counting_draws() as drawn:
            res = sim.run()
            torch.cuda.synchronize()
        if decode_layered_cuda.launches != sim.rx_calls or sim.rx_calls <= 0:
            raise AssertionError(f"block {block_slots}: {decode_layered_cuda.launches} kernel "
                                 f"launches for {sim.rx_calls} sch_receive_batch calls")
        _held_draws(drawn, 1, f"block_slots={block_slots} frame")
        _check_against(_cell_outcome(sim, res), CELL_EXPECT, f"block_slots={block_slots} frame")
        return sim, _result_leaves(res), prof

    loop_sim, loop_a, _ = frame(0)
    _, loop_b, _ = frame(0)
    noisy = _differing(loop_a, loop_b)
    for k in noisy:
        if not _within_float_tol(k, loop_a[k], loop_b[k]):
            raise AssertionError(f"two slot-loop frames differ in {k} by {noisy[k]}")
    print(f"block mode 273 PRB: two slot-loop frames of seed 0 equal on all "
          f"{len(loop_a)} result leaves except {noisy or 'none'}", flush=True)
    for bs in (8, 1):
        sim, leaves, prof = frame(bs, profiled=bs == 8)
        diff = _differing(loop_a, leaves)
        bad = {k: v for k, v in diff.items()
               if k not in noisy or not _within_float_tol(k, loop_a[k], leaves[k])}
        if bad:
            raise AssertionError(f"block_slots={bs} differs from the slot loop in {bad}")
        if sim.metrics.trace != loop_sim.metrics.trace and not noisy:
            raise AssertionError(f"block_slots={bs}: trace differs from the slot loop")
        msg = (f"block_slots={bs} frame: equal to the slot loop on all {len(leaves)} result "
               f"leaves" + (f" (float surfaces within tolerance: {sorted(diff)})" if diff else "")
               + f", CELL_EXPECT held, {sim.rx_calls} kernel launches = receives, segments "
               f"{sim.segment_lens}")
        if prof is not None:
            copies = _segment_copies(prof)
            if copies["segments"] != len(sim.segment_lens):
                raise AssertionError(f"block mode: {copies['segments']} cell.segment ranges "
                                     f"for {len(sim.segment_lens)} segments")
            if copies["d2h_out"] == 0 or copies["d2h_in"] + copies["d2h_out"] != copies[
                    "d2h_device_events"]:
                raise AssertionError(f"block mode: device-to-host copies not attributed: {copies}")
            if copies["d2h_in"] != 0:
                raise AssertionError(f"block mode: {copies['d2h_in']} device-to-host copies "
                                     f"inside segments, from {copies['d2h_ops_in'][:10]}")
            msg += (f"; profiler: 0 device-to-host copies inside the {copies['segments']} "
                    f"cell.segment ranges ({copies['d2h_out']} outside), "
                    f"{copies['h2d_in']} host-to-device copies inside ({copies['h2d_out']} "
                    f"outside)")
        print(msg, flush=True)
    reads = []
    for _ in range(BLOCK_READINGS):
        sim = example_cell(device=dev, block_slots=8)
        torch.cuda.synchronize()
        decode_layered_cuda.launches = 0
        with _counting_draws() as drawn:
            t1 = time.perf_counter()
            sim.run(finalize=False)
            torch.cuda.synchronize()
            slot_ms = (time.perf_counter() - t1) * 1e3 / sim.num_slots
            launches = decode_layered_cuda.launches
            res = sim.finalize(sensing=False)
        if launches != sim.rx_calls:
            raise AssertionError(f"block timed frame: {launches} launches, {sim.rx_calls} "
                                 f"receives")
        draws = _held_draws(drawn, 0, f"block timed frame {len(reads)}")
        out = _cell_outcome(sim, res)
        _check_against(out, {k: v for k, v in CELL_EXPECT.items()
                             if k != "detections" and k not in CELL_EST_TOL},
                       f"block timed frame {len(reads)}")
        reads.append({"cell_block_slot_ms": slot_ms, "ldpc_layered_launches": launches,
                      "segments": len(sim.segment_lens), "threefry": draws})
    mid = sorted(r["cell_block_slot_ms"] for r in reads)[BLOCK_READINGS // 2]
    print("block mode 273 PRB, block_slots=8, three frames on fresh simulators: " + json.dumps({
        "cell_block_slot_ms": mid,
        "cell_block_slot_ms_readings": [r["cell_block_slot_ms"] for r in reads],
        "cell_slot_ms": cell_slot_ms,
        "ldpc_layered_launches_per_frame": [r["ldpc_layered_launches"] for r in reads],
        "segments_per_frame": [r["segments"] for r in reads],
        "threefry": reads[0]["threefry"]}), flush=True)
    return reads[0]["ldpc_layered_launches"], reads[0]["threefry"]


def phase_distributed(dev):
    """Phase 9b: the parallel/ functions and the mesh paths of the network
    runner and the engine at a world of one on the card (NCCL). Returns the
    kernel launches of the mesh link step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from isac_tpu_torch.example import example_cell, example_link_batch, example_network
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda
    from isac_tpu_torch.parallel import global_mesh, init_distributed, make_link_step

    info = init_distributed()
    try:
        if dist.get_backend() != "nccl" or info["num_processes"] != 1:
            raise AssertionError(f"distributed: {dist.get_backend()} {info}")
        g, (tb, w, h, noise), _ = example_link_batch(n_prb=273, n_links=4, mcs=19,
                                                     n_layers=2, device=dev)
        ref = make_link_step(g, device=dev)[0](tb, w, h, noise)
        step, _ = make_link_step(g, device=dev, mesh=global_mesh({"link": -1}))
        torch.cuda.synchronize()
        decode_layered_cuda.launches = 0
        out = step(tb, w, h, noise)
        torch.cuda.synchronize()
        link_launches = decode_layered_cuda.launches
        d = float((out["sinr_db"] - ref["sinr_db"]).abs().max())
        if not (torch.equal(out["crc_ok"], ref["crc_ok"]) and torch.equal(out["tb"], ref["tb"])
                and d <= SLICE_SINR_ATOL_DB and int(out["n_ok"]) == int(ref["crc_ok"].sum())
                and link_launches > 0):
            raise AssertionError(f"mesh link step: n_ok {int(out['n_ok'])}, d sinr {d}, "
                                 f"{link_launches} launches")
        print(f"distributed world of one ({dist.get_backend()}, {info}): mesh link step 273 PRB "
              f"x4 links = the meshless step (crc_ok/tb equal, max |d sinr_db| {d:.3g} dB), "
              f"n_ok {int(out['n_ok'])}, {link_launches} kernel launches", flush=True)

        mesh_c = global_mesh({"cell": -1})
        runner = example_network(device=dev, sensing=False, mesh=mesh_c)

        def host_path(*args):
            raise AssertionError("the mesh runner took the per-destination path")

        runner._dl_ext = host_path
        decode_layered_cuda.launches = 0
        t1 = time.perf_counter()
        results = runner.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        rx_calls = sum(s.rx_calls for s in runner.sims)
        if runner.mesh is not mesh_c or decode_layered_cuda.launches != rx_calls:
            raise AssertionError(f"mesh network: mesh {runner.mesh}, "
                                 f"{decode_layered_cuda.launches} launches for {rx_calls}")
        for c, (o, exp) in enumerate(zip(_network_outcome(runner, results),
                                         NETWORK_EXPECT["cells"])):
            _check_against(o, {k: v for k, v in exp.items()
                               if k != "detections" and k not in CELL_EST_TOL},
                           f"mesh network cell {c}")
        print(f"distributed: SyncNetworkRunner(mesh=) 273 PRB x2 cells, one frame without "
              f"sensing through network_cross_rx: NETWORK_EXPECT held, {rx_calls} launches = "
              f"receives, {secs * 1e3 / runner.num_slots:.1f} ms a slot", flush=True)
        del runner, results

        sim = example_cell(device=dev, mesh=global_mesh({"cell": 1, "time": -1}))
        res = sim.run()
        _check_against(_cell_outcome(sim, res), CELL_EXPECT, "mesh engine")
        est = res["sensing"]["estimates"]
        sim.mesh = None  # the same engine's post-pass with the serial map
        serial = sim.run_sensing()["estimates"]
        rel = float((est["rdm"] - serial["rdm"]).abs().max() / serial["rdm"].abs().max())
        same = all(np.array_equal(est[k].cpu().numpy(), serial[k].cpu().numpy(), equal_nan=True)
                   for k in ("valid", "rngEst", "velEst", "aziEst"))
        if not (rel <= SENSING_RDM_TOL and same):
            raise AssertionError(f"mesh engine: RDM {rel} of max from the serial map, "
                                 f"detections equal: {same}")
        print(f"distributed: CellSimulator(mesh=) 273 PRB, time-sharded RDM within "
              f"{rel:.3g} of max|RDM| of the serial map (bound {SENSING_RDM_TOL}), the same "
              f"detections, CELL_EXPECT held", flush=True)
    finally:
        dist.destroy_process_group()
    return link_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a "
              "CUDA card", file=sys.stderr)
        return 1
    from isac_tpu_torch.utils import cuda_build
    from isac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    smi = _smi_line()
    print(f"device: {smi}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # phase 1: build the path's kernel sources
    t_start = time.perf_counter()
    for name in ("ldpc_layered", "threefry_normal"):
        t0 = time.perf_counter()
        cuda_build.build(name)
        secs = time.perf_counter() - t0
        log = cuda_build.BUILD_LOG.get(name, "(already built)")
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: {secs:.1f} s; " + " | ".join(info), flush=True)

    # phase 2: kernels against their plain versions on the card
    threefry, threefry_err = phase_threefry(dev)
    main_k, max_err = phase_kernels(dev)

    # phase 3: slice parity
    phase_slice_parity(dev)

    # phase 4: the main path at full width (launch counts read from this run)
    res = phase_main_path(dev)

    # phase 5: the sensing chain (no hand-written kernel on this path)
    phase_sensing_parity(dev)
    sen_params, sen_grids = phase_sensing_full(dev)
    phase_sensing_isac(dev)
    phase_sensing_music_2d(dev, sen_params, sen_grids)
    del sen_grids, sen_params
    torch.cuda.empty_cache()

    # phase 6: the link loop (its receive launches the same kernel)
    max_err = max(max_err, phase_loop_parity(dev))
    _, loop_launches, loop_err = phase_loop_full(dev)
    max_err = max(max_err, loop_err)
    phase_flooding(dev)

    # phase 7: the per-cell engine (its receives launch the same kernel)
    t7 = time.perf_counter()
    phase_cell_golden(dev)
    phase_cell_harq(dev)
    cell_res, cell_launches, cell_err = phase_cell_full(dev)
    max_err = max(max_err, cell_err)
    torch.cuda.empty_cache()

    # phase 8: the top-level entry and the lockstep network (the same kernel)
    t8 = time.perf_counter()
    phase_network_parity(dev)
    phase_city_entry(dev)
    net_res, net_launches, net_err = phase_network_full(dev)
    max_err = max(max_err, net_err)
    torch.cuda.empty_cache()

    # phase 9: block mode and the distributed paths (the same kernel)
    t9 = time.perf_counter()
    block_launches, block_draws = phase_block_mode(dev, cell_res["cell_slot_ms"])
    torch.cuda.empty_cache()
    mesh_link_launches = phase_distributed(dev)
    torch.cuda.empty_cache()

    # phase 10: seven co-channel cells at full width (the same kernel)
    t10 = time.perf_counter()
    net7_launches, net7_err, net7_draws = phase_network7(dev)
    max_err = max(max_err, net7_err)
    t_end = time.perf_counter()
    print(f"script seconds after import: {t_end - t_start:.1f} in all, phases 1-6 "
          f"{t7 - t_start:.1f}, phase 7 {t8 - t7:.1f}, phase 8 {t9 - t8:.1f}, "
          f"phase 9 {t10 - t9:.1f}, phase 10 {t_end - t10:.1f}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "ldpc_layered", "route": "cuda",
        "source": "isac_tpu_torch/csrc/ldpc_layered.cu",
        "replaces": "isac_tpu/ops/ldpc_layered.py:169",
        "launches": res["ldpc_layered_launches"],
        "launches_by_path": {"link_step": res["ldpc_layered_launches"],
                             "dl_loop": loop_launches["dl"], "ul_loop": loop_launches["ul"],
                             "cell": cell_launches, "network": net_launches,
                             "block": block_launches, "mesh_link": mesh_link_launches,
                             "network7": net7_launches},
        "max_abs_err": max_err,
        "ms": main_k["ms"], "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"], "bound_by": main_k["bound_by"],
        "library_ms": None, "ms_readings": main_k["ms_readings"],
        "msg_traffic_bound_ms": main_k["msg_traffic_bound_ms"],
    }, {
        "name": "threefry_normal", "route": "cuda",
        "source": "isac_tpu_torch/csrc/threefry_normal.cu",
        "replaces": None, "max_abs_err": threefry_err, "library_ms": None,
        "launches": cell_res["threefry"]["launches"],
        "launches_by_path": {"cell": cell_res["threefry"]["launches"],
                             "network": net_res["threefry"]["launches"],
                             "block": block_draws["launches"],
                             "network7": net7_draws["launches"]},
        "draws_by_path": {"cell": cell_res["threefry"], "network": net_res["threefry"],
                          "block": block_draws, "network7": net7_draws,
                          "cell_untimed": cell_res["threefry_untimed"],
                          "network_untimed": net_res["threefry_untimed"]},
        "shapes": {name: list(shape) for name, shape in THREEFRY_SHAPES.items()},
        **{f"{name}_{k}": v for name, t in threefry.items() for k, v in t.items()},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
