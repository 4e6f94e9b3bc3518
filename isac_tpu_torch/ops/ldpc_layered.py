"""Layered (serial-C) normalized min-sum LDPC decoding (counterpart of
isac_tpu/ops/ldpc_layered.py).

Two implementations with identical numerics (same row order, same
min1/min2/argmin self-exclusion with the first index winning ties, same
multiply order ``norm * sprod * sgn * mag``):

- ``_decode_layered_torch``: the plain version, a loop over rows with the
  reference's uniform padded gather plan (``_scan_plan``, the form of the
  reference's ``_decode_layered_xla``). The CPU tests and the card-side
  comparison in chip_smoke.py use it; on a CUDA tensor the main path never
  takes it.
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


def _decode_layered_torch(llr: torch.Tensor, bg: int, z: int, n_iter: int,
                          norm: float) -> torch.Tensor:
    """Posterior LLRs after n_iter layered sweeps. llr [B, n_cols, z] f32."""
    code, _, _, dmax = _scan_plan(bg, z)
    idx, mask = _scan_tensors(bg, z, llr.device)
    b = llr.shape[0]
    lf = torch.cat([llr.reshape(b, code.n_cols * z).to(torch.float32),
                    llr.new_zeros((b, dmax * z), dtype=torch.float32)], dim=-1)
    m = lf.new_zeros((b, code.n_rows, dmax, z))
    d_iota = torch.arange(dmax, device=llr.device).view(1, dmax, 1)
    inf = torch.tensor(float("inf"), device=llr.device)
    for _ in range(n_iter):
        for r in range(code.n_rows):
            mask_r = mask[r]  # [D, 1]
            t = lf[:, idx[r]].view(b, dmax, z) - m[:, r]
            sgn = torch.where(t >= 0, 1.0, -1.0) * mask_r + (1.0 - mask_r)
            mag = torch.where(mask_r > 0, torch.abs(t), inf)
            m1 = torch.amin(mag, dim=1, keepdim=True)
            arg = torch.argmin(mag, dim=1, keepdim=True)  # first minimum wins
            m2 = torch.amin(torch.where(d_iota == arg, inf, mag), dim=1, keepdim=True)
            sprod = torch.prod(sgn, dim=1, keepdim=True)
            new = norm * sprod * sgn * torch.where(d_iota == arg, m2, m1) * mask_r
            lf[:, idx[r]] = (t + new).view(b, dmax * z)
            m[:, r] = new
    return lf[:, : code.n_cols * z].view(b, code.n_cols, z)


# ------------------------------------------------------------- CUDA kernel


@lru_cache(maxsize=32)
def _csr_plan(bg: int, z: int, device: torch.device):
    """Row pointers and per-edge (col, shift), int32 in row order, on device,
    and the largest row degree."""
    code, plan = _row_plan(bg, z)
    deg = [len(r) for r in plan]
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    cols = np.asarray([c for r in plan for _, c, _ in r], np.int32)
    shifts = np.asarray([s for r in plan for _, _, s in r], np.int32)
    return (*(torch.as_tensor(a, device=device) for a in (row_ptr, cols, shifts)), max(deg))


def _kernel_fn():
    from isac_tpu_torch.utils import cuda_build

    fn = cuda_build.load("ldpc_layered").ldpc_layered_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
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
    out = torch.empty_like(llr)
    b = llr.shape[0]
    if b == 0:
        return out
    row_ptr, cols, shifts, max_deg = _csr_plan(bg, z, llr.device)
    msg = torch.zeros((b, cols.shape[0], z), dtype=torch.float32, device=llr.device)
    fn = _kernel_fn()
    with torch.cuda.device(llr.device):
        err = fn(llr.data_ptr(), out.data_ptr(), msg.data_ptr(), row_ptr.data_ptr(),
                 cols.data_ptr(), shifts.data_ptr(), b, code.n_rows, code.n_cols,
                 cols.shape[0], max_deg, z, n_iter, float(norm),
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
