"""Layered (serial-C) normalized min-sum LDPC decoding (counterpart of
isac_tpu/ops/ldpc_layered.py).

Two implementations with identical numerics (same row order, same
min1/min2/argmin self-exclusion with the first index winning ties, same
multiply order ``norm * sprod * sgn * mag``). Both keep a row's
check-to-variable messages compressed per (row, lane) as min1, min2 and one
packed word (a sign bit per edge, the index of the minimum above them),
rebuild a message from them with the multiply order it was made with (so the
rebuilt float has the same bits), and neither read nor subtract a message in
the first sweep, where all are zero:

- ``_decode_layered_torch``: the plain version, a loop over rows with the
  reference's uniform padded gather plan (``_scan_plan``, the form of the
  reference's ``_decode_layered_xla``, to which its posterior is bit-equal).
  The CPU tests and the card-side comparison in chip_smoke.py use it; on a
  CUDA tensor the main path never takes it.
- ``decode_layered_cuda``: the hand-written Hopper kernel
  (csrc/ldpc_layered.cu, replacing the TPU kernel ``_pallas_decoder``),
  bit-equal in posterior to the plain version on the card.

``decode_layered(..., impl=None)`` picks the kernel for a CUDA tensor and the
plain version for a CPU tensor; ``impl="cuda"`` on a CPU tensor raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.ops import ldpc
from isac_tpu_torch.ops.ldpc import lifted_code


@lru_cache(maxsize=32)
def _row_plan(bg: int, z: int):
    """Per-row static edge lists [(edge_id, col, shift), ...]."""
    code = lifted_code(bg, z)
    plan = [[] for _ in range(code.n_rows)]
    for e in range(code.rows.shape[0]):
        plan[int(code.rows[e])].append((e, int(code.cols[e]), int(code.shifts[e])))
    return code, tuple(tuple(r) for r in plan)


# ------------------------------------------------------------ plain version


@lru_cache(maxsize=32)
def _scan_plan(bg: int, z: int):
    """Uniform padded per-row gather plan. Rows are padded to the max degree
    D; each padded slot addresses a DISTINCT dummy z-block after the real
    columns. idx[r, d, i] addresses the flattened [(n_cols + D) * z]
    posterior: real slots point at col*z + (i + shift) % z, so one gather
    does both the column pick and the cyclic lift."""
    code, plan = _row_plan(bg, z)
    dmax = max(len(r) for r in plan)
    n_rows = len(plan)
    idx = np.zeros((n_rows, dmax, z), np.int64)
    mask = np.zeros((n_rows, dmax), np.float32)
    i = np.arange(z)
    for r, edges in enumerate(plan):
        for d in range(dmax):
            if d < len(edges):
                _, c, s = edges[d]
                idx[r, d] = c * z + (i + s) % z
                mask[r, d] = 1.0
            else:
                idx[r, d] = (code.n_cols + d) * z + i
    return code, idx, mask, dmax


@lru_cache(maxsize=32)
def _scan_tensors(bg: int, z: int, device: torch.device):
    _, idx, mask, _ = _scan_plan(bg, z)
    return (torch.as_tensor(idx.reshape(idx.shape[0], -1), device=device),
            torch.as_tensor(mask[..., None], device=device))


# The packed word of a (row, lane): bit d is set where edge d's sign is -1,
# and the index of the row's minimum (5 bits) sits above the sign bits. The
# kernel's SIGN_BITS is the same number; a row degree above it does not fit.
_SIGN_BITS = 19


def _pack_state(arg: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """arg [..., 1, z] (index of the minimum) and neg [..., D, z] bool
    (edge d's sign is -1) -> packed int32 words [..., z]."""
    d = neg.shape[-2]
    if d > _SIGN_BITS:
        raise ValueError(f"row degree {d} does not fit the packed word")
    bit = (1 << torch.arange(d, dtype=torch.int32, device=neg.device)).view(d, 1)
    return (neg * bit).sum(dim=-2, dtype=torch.int32) | (
        arg.squeeze(-2).to(torch.int32) << _SIGN_BITS)


def _unpack_state(word: torch.Tensor, d: int):
    """Packed words [..., z] -> (arg [..., 1, z] int64, neg [..., d, z] bool)."""
    word = word.unsqueeze(-2)
    shift = torch.arange(d, dtype=torch.int32, device=word.device).view(d, 1)
    return (word >> _SIGN_BITS).to(torch.int64), ((word >> shift) & 1).bool()


def _decode_layered_torch(llr: torch.Tensor, bg: int, z: int, n_iter: int,
                          norm: float) -> torch.Tensor:
    """Posterior LLRs after n_iter layered sweeps. llr [B, n_cols, z] f32."""
    code, _, _, dmax = _scan_plan(bg, z)
    idx, mask = _scan_tensors(bg, z, llr.device)
    b = llr.shape[0]
    lf = torch.cat([llr.reshape(b, code.n_cols * z).to(torch.float32),
                    llr.new_zeros((b, dmax * z), dtype=torch.float32)], dim=-1)
    m1s = lf.new_empty((b, code.n_rows, 1, z))
    m2s = torch.empty_like(m1s)
    words = torch.empty((b, code.n_rows, z), dtype=torch.int32, device=llr.device)
    d_iota = torch.arange(dmax, device=llr.device).view(1, dmax, 1)
    inf = torch.tensor(float("inf"), device=llr.device)

    def messages(m1, m2, arg, neg, mask_r):
        sprod = 1.0 - 2.0 * (neg.sum(dim=1, keepdim=True) % 2)
        sgn = torch.where(neg, -1.0, 1.0)
        return norm * sprod * sgn * torch.where(d_iota == arg, m2, m1) * mask_r

    for it in range(n_iter):
        for r in range(code.n_rows):
            mask_r = mask[r]  # [D, 1]
            t = lf[:, idx[r]].view(b, dmax, z)
            if it > 0:
                arg, neg = _unpack_state(words[:, r], dmax)
                t = t - messages(m1s[:, r], m2s[:, r], arg, neg, mask_r)
            neg = ~(t >= 0) & (mask_r > 0)
            mag = torch.where(mask_r > 0, torch.abs(t), inf)
            m1 = torch.amin(mag, dim=1, keepdim=True)
            arg = torch.argmin(mag, dim=1, keepdim=True)  # first minimum wins
            m2 = torch.amin(torch.where(d_iota == arg, inf, mag), dim=1, keepdim=True)
            lf[:, idx[r]] = (t + messages(m1, m2, arg, neg, mask_r)).view(b, dmax * z)
            m1s[:, r], m2s[:, r], words[:, r] = m1, m2, _pack_state(arg, neg)
    return lf[:, : code.n_cols * z].view(b, code.n_cols, z)


# ------------------------------------------------------------- CUDA kernel


@lru_cache(maxsize=32)
def _csr_plan(bg: int, z: int, device: torch.device):
    """Row pointers [n_rows + 1] and the per-edge table [n_edges, 2], int32 in
    row order, on device, and the largest row degree. The table holds, per
    edge, the byte offset (col*z + shift)*4 of lane 0's posterior value and
    z - shift, the first lane whose value lies z floats further back."""
    code, plan = _row_plan(bg, z)
    deg = [len(r) for r in plan]
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    edges = np.asarray([((c * z + s) * 4, z - s) for r in plan for _, c, s in r], np.int32)
    return (torch.as_tensor(row_ptr, device=device),
            torch.as_tensor(edges, device=device).contiguous(), max(deg))


# The kernel's CTA: at most this many threads, thread t serving lane t % z of
# the CTA's codeword t // z.
_MAX_THREADS = 384
# Shared memory a block may have on Hopper, and the most it may take for two
# blocks to share an SM (228 KB per SM, 1 KB reserved per block).
_SMEM_MAX = 227 * 1024
_SMEM_TWO_PER_SM = 113 * 1024


def _smem_bytes(n_rows: int, n_cols: int, n_edges: int, z: int, cw_per_cta: int) -> int:
    """The kernel's dynamic shared memory: the edge table and the row
    pointers, padded to 16 bytes, and cw_per_cta posteriors (the layout at the
    top of its kernel body)."""
    return -(-(8 * n_edges + 4 * (n_rows + 1)) // 16) * 16 + 4 * cw_per_cta * n_cols * z


def _cw_per_cta(b: int, n_rows: int, n_cols: int, n_edges: int, z: int, n_sm: int) -> int:
    """Codewords per CTA: one while the batch has a CTA or fewer per SM (the
    decode is a latency chain, so spread first); beyond that as many as keep a
    CTA within its threads and two CTAs on an SM."""
    by_threads = _MAX_THREADS // z
    by_smem = (_SMEM_TWO_PER_SM - _smem_bytes(n_rows, n_cols, n_edges, z, 0)) // (4 * n_cols * z)
    return max(1, min(-(-b // n_sm), by_threads, by_smem))


def _kernel_fn():
    from isac_tpu_torch.utils import cuda_build

    fn = cuda_build.load("ldpc_layered").ldpc_layered_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_layered_cuda(llr: torch.Tensor, bg: int, z: int, n_iter: int,
                        norm: float) -> torch.Tensor:
    """Posterior [B, n_cols, z] from llr [B, n_cols, z] via the Hopper kernel.
    Counts each launch in ``decode_layered_cuda.launches``."""
    code = lifted_code(bg, z)
    if not llr.is_cuda:
        raise ValueError("decode_layered_cuda needs a CUDA tensor")
    if llr.dtype != torch.float32 or not llr.is_contiguous():
        raise ValueError("decode_layered_cuda needs contiguous float32 input")
    if llr.dim() != 3 or tuple(llr.shape[1:]) != (code.n_cols, z):
        raise ValueError(f"expected [B, {code.n_cols}, {z}], got {tuple(llr.shape)}")
    if n_iter < 0:
        raise ValueError(f"n_iter must not be negative, got {n_iter}")
    b = llr.shape[0]
    if b == 0 or n_iter == 0:
        return llr.clone()
    row_ptr, edges, max_deg = _csr_plan(bg, z, llr.device)
    n_edges = edges.shape[0]
    if max_deg > _SIGN_BITS:
        raise ValueError(f"row degree {max_deg} does not fit the kernel's packed word "
                         f"({_SIGN_BITS} sign bits)")
    if z > _MAX_THREADS or code.n_rows < 2:
        raise ValueError(f"the kernel takes z <= {_MAX_THREADS} and at least 2 rows, "
                         f"got z={z}, {code.n_rows} rows")
    n_sm = torch.cuda.get_device_properties(llr.device).multi_processor_count
    cw_per_cta = _cw_per_cta(b, code.n_rows, code.n_cols, n_edges, z, n_sm)
    smem = _smem_bytes(code.n_rows, code.n_cols, n_edges, z, cw_per_cta)
    if smem > _SMEM_MAX:
        raise ValueError(f"BG{bg} Z={z} needs {smem} bytes of shared memory per block, "
                         f"above the card's {_SMEM_MAX}")
    out = torch.empty_like(llr)
    state = torch.empty((b, code.n_rows, 3, z), dtype=torch.int32, device=llr.device)
    fn = _kernel_fn()
    with torch.cuda.device(llr.device):
        err = fn(llr.data_ptr(), out.data_ptr(), state.data_ptr(), row_ptr.data_ptr(),
                 edges.data_ptr(), b, code.n_rows, code.n_cols, n_edges, max_deg, z,
                 n_iter, cw_per_cta, float(norm),
                 torch.cuda.current_stream(llr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ldpc_layered kernel launch failed: cudaError {err}")
    decode_layered_cuda.launches += 1
    return out


decode_layered_cuda.launches = 0


# ---------------------------------------------------------------- public API


def layered_posterior(llr: torch.Tensor, bg: int, z: int, n_iter: int = 6,
                      norm: float = 0.75, impl: str | None = None) -> torch.Tensor:
    """Posterior LLRs [..., n_cols, z] for llr [..., n_full]."""
    code = lifted_code(bg, z)
    lead = llr.shape[:-1]
    x = llr.reshape(-1, code.n_cols, z).to(torch.float32).contiguous()
    if impl is None:
        impl = "cuda" if x.is_cuda else "torch"
    if impl == "cuda":
        total = decode_layered_cuda(x, bg, z, n_iter, norm)
    elif impl == "torch":
        total = _decode_layered_torch(x, bg, z, n_iter, norm)
    else:
        raise ValueError(f"impl must be None, 'torch' or 'cuda', got {impl!r}")
    return total.reshape(*lead, code.n_cols, z)


def decode_layered(llr: torch.Tensor, bg: int, z: int, n_iter: int = 6,
                   norm: float = 0.75, impl: str | None = None):
    """Layered normalized min-sum. llr [..., n_full] (positive = bit 0)
    -> (hard bits [..., K] int8, parity_ok [...] bool).

    impl: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor) | 'torch' | 'cuda' (raises on a CPU tensor)."""
    code = lifted_code(bg, z)
    total = layered_posterior(llr, bg, z, n_iter, norm, impl)
    hard_full = (total < 0).reshape(*llr.shape[:-1], code.n_cols * z)
    hard = hard_full[..., : code.k].to(torch.int8)
    return hard, ldpc.parity_check(hard_full, bg, z)
