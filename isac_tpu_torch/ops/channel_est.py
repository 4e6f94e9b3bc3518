"""Receiver DSP: DM-RS channel estimation and MMSE equalization (counterpart
of isac_tpu/ops/channel_est.py).

Every function takes any number of leading batch axes (the link axis of the
batched link step). The L<=2 MMSE keeps the reference's plane form and its
exact expression order (det, q = clip(nv*a22/det)); the sums inside the
DFT-basis interpolation are matrix products whose order of summation differs
from XLA's, so H and the equalized symbols agree with the reference to a few
float32 ulps (tests/test_torch_phy.py states the tolerance).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _mean_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.mean(x, dim=tuple(range(-n, 0)))


def estimate_channel_canonical(
    rx_c: torch.Tensor,  # [..., n_rx, 14, 12*n_prb] compact (allocated-PRB) grid
    refs: torch.Tensor,  # [..., n_dsym, 6*n_prb] base DM-RS sequence values
    ports: tuple,
    dsyms: tuple,
    n_prb: int,
    n_basis: int = 6,
):
    """Shape-static DM-RS estimator on the canonical compact grid, with
    per-bundle half-period DFT-basis interpolation over 2-PRB bundles (and an
    odd-PRB tail bundle).

    Returns (H [..., 14, 12*n_prb, n_rx, n_ports], nvar [...])."""
    n_rx, n_sym = rx_c.shape[-3], rx_c.shape[-2]
    lead = rx_c.shape[:-3]
    dev = rx_c.device
    active = set(ports)
    occ = torch.as_tensor(np.tile(np.array([1.0, -1.0], np.float32), 3 * n_prb), device=dev)
    sym_j = torch.as_tensor(np.asarray(dsyms, np.int64), device=dev)
    nb_full = n_prb // 2
    tail = n_prb % 2
    refs_b = refs.unsqueeze(-3)  # [..., 1, n_dsym, 6*n_prb]
    h_ports = []
    nvar_candidates = []
    for port in ports:
        delta = port // 2
        pil = rx_c.index_select(-2, sym_j)[..., delta::2]  # [..., n_rx, n_dsym, 6*n_prb]
        ref_p = refs_b if port % 2 == 0 else refs_b * occ
        ls = pil * torch.conj(ref_p)
        e, o = ls[..., 0::2], ls[..., 1::2]
        h_pair = (e + o) / 2.0 if port % 2 == 0 else (e - o) / 2.0
        partner = port + 1 if port % 2 == 0 else port - 1
        if partner not in active:
            rej = (e - o) / 2.0 if port % 2 == 0 else (e + o) / 2.0
            nvar_candidates.append(_mean_last(torch.abs(rej) ** 2, 3) * 2.0)
        if len(dsyms) >= 2:
            td = h_pair[..., 1:, :] - h_pair[..., :-1, :]
            nvar_candidates.append(_mean_last(torch.abs(td) ** 2, 3))
        if n_prb >= 1:
            fp = h_pair.reshape(*h_pair.shape[:-1], -1, 3)
            fd = fp[..., 0] - 2.0 * fp[..., 1] + fp[..., 2]
            nvar_candidates.append(_mean_last(torch.abs(fd) ** 2, 3) / 3.0)
        if partner not in active:
            src, per_prb, pat_off = ls, 6, np.array([0, 2, 4, 6, 8, 10])
            nb_eff = n_basis
        else:  # OCC pair decode (3 estimates/PRB at pair centers)
            src, per_prb, pat_off = h_pair, 3, np.array([1, 5, 9])
            nb_eff = min(n_basis, 3)
        parts = []
        if nb_full:
            pat = tuple(np.concatenate([pat_off, pat_off + 12]) + delta)
            m = torch.as_tensor(_dft_interp_matrix(pat, 24, nb_eff), device=dev)
            xb = src[..., : nb_full * 2 * per_prb].reshape(
                *lead, n_rx, len(dsyms), nb_full, 2 * per_prb)
            hb = torch.matmul(xb, m.T)  # [..., nb, 24]
            parts.append(hb.reshape(*lead, n_rx, len(dsyms), nb_full * 24))
        if tail:
            pat = tuple(pat_off + delta)
            m = torch.as_tensor(_dft_interp_matrix(pat, 12, min(nb_eff, 3)), device=dev)
            parts.append(torch.matmul(src[..., nb_full * 2 * per_prb:], m.T))
        h_freq = torch.cat(parts, dim=-1)  # [..., n_rx, n_dsym, 12*n_prb]
        h_ports.append(_interp_time(h_freq, np.asarray(dsyms), n_sym))
    h = torch.stack(h_ports, dim=-1)  # [..., n_rx, n_sym, n_sc_c, n_ports]
    nd = h.dim()
    h = h.permute(*range(nd - 4), nd - 3, nd - 2, nd - 4, nd - 1)
    noise_var = torch.clamp_min(torch.amin(torch.stack(nvar_candidates, dim=-1), dim=-1), 1e-10)
    return h, noise_var


@lru_cache(maxsize=256)
def _dft_interp_matrix(pattern: tuple, width: int, n_basis: int | None = None) -> np.ndarray:
    """LS trigonometric-interpolation matrix [width, n_pilots] for one
    precoding bundle: h(k) = sum_m a_m exp(-2j pi k m / (2*width)) fit by
    least squares to the pilots at `pattern` (half-period basis)."""
    p = np.asarray(pattern, np.float64)
    if n_basis is None:
        n_basis = max(len(pattern) // 2, 2)
    n_basis = max(min(n_basis, len(pattern)), 2)
    m = np.arange(n_basis)
    per = 2.0 * width
    b = np.exp(-2j * np.pi * np.outer(p, m) / per)
    e = np.exp(-2j * np.pi * np.outer(np.arange(width), m) / per)
    return (e @ np.linalg.pinv(b, rcond=1e-3)).astype(np.complex64)


def _interp_time(hf: torch.Tensor, dmrs_syms: np.ndarray, n_sym: int) -> torch.Tensor:
    """[..., n_dmrs_sym, n_sc] -> [..., n_sym, n_sc] (linear over symbols)."""
    if len(dmrs_syms) == 1:
        return hf[..., :1, :].expand(*hf.shape[:-2], n_sym, hf.shape[-1])
    dev = hf.device
    syms = np.arange(n_sym)
    right_t = np.clip(np.searchsorted(dmrs_syms, syms), 1, len(dmrs_syms) - 1)
    left_t = right_t - 1
    t0, t1 = dmrs_syms[left_t], dmrs_syms[right_t]
    wt = np.clip((syms - t0) / np.maximum(t1 - t0, 1), 0.0, 1.0).astype(np.float32)
    wt_t = torch.as_tensor(wt, device=dev)[:, None]
    return (hf.index_select(-2, torch.as_tensor(left_t, device=dev)) * (1.0 - wt_t)
            + hf.index_select(-2, torch.as_tensor(right_t, device=dev)) * wt_t)


def _mmse_planes(rx_grid: torch.Tensor, h: torch.Tensor, noise_var, n_layers: int):
    """L<=2 MMSE on [n_sym, n_sc] planes, in the reference's exact expression
    order: A = H^H H + nv I; x = A^-1 H^H y; mu_l = 1 - nv*[A^-1]_ll;
    sym = x/mu; sinr = mu/(1-mu), with q = 1-mu computed directly."""
    n_rx = rx_grid.shape[-3]
    cdt = rx_grid.dtype
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=rx_grid.device)[..., None, None]
    y = [rx_grid[..., r, :, :] for r in range(n_rx)]
    h0 = [h[..., r, 0] for r in range(n_rx)]
    a11 = sum(torch.abs(v) ** 2 for v in h0) + nv
    r0 = sum(torch.conj(hr) * yr for hr, yr in zip(h0, y))
    eps = 1e-6
    if n_layers == 1:
        q0 = torch.clamp(nv / a11, eps, 1.0 - eps)
        mu0 = 1.0 - q0
        x0 = r0 / a11.to(cdt)
        return (x0 / mu0.to(cdt)).unsqueeze(-3), (mu0 / q0).unsqueeze(-3)
    h1 = [h[..., r, 1] for r in range(n_rx)]
    a22 = sum(torch.abs(v) ** 2 for v in h1) + nv
    a12 = sum(torch.conj(p) * q for p, q in zip(h0, h1))
    det = a11 * a22 - torch.abs(a12) ** 2
    det = torch.clamp_min(det, 1e-20)
    r1 = sum(torch.conj(hr) * yr for hr, yr in zip(h1, y))
    x0 = (a22.to(cdt) * r0 - a12 * r1) / det.to(cdt)
    x1 = (a11.to(cdt) * r1 - torch.conj(a12) * r0) / det.to(cdt)
    q0 = torch.clamp(nv * a22 / det, eps, 1.0 - eps)
    q1 = torch.clamp(nv * a11 / det, eps, 1.0 - eps)
    mu0, mu1 = 1.0 - q0, 1.0 - q1
    sym = torch.stack([x0 / mu0.to(cdt), x1 / mu1.to(cdt)], dim=-3)
    sinr = torch.stack([mu0 / q0, mu1 / q1], dim=-3)
    return sym, sinr


def mmse_equalize(rx_grid: torch.Tensor, h: torch.Tensor, noise_var):
    """Per-RE MMSE with bias correction. rx_grid [..., n_rx, n_sym, n_sc],
    h [..., n_sym, n_sc, n_rx, n_layers], noise_var [...] ->
    (symbols [..., n_layers, n_sym, n_sc], sinr [..., n_layers, n_sym, n_sc])."""
    n_layers = h.shape[-1]
    if n_layers <= 2:
        return _mmse_planes(rx_grid, h, noise_var, n_layers)
    nd = rx_grid.dim()
    y = rx_grid.permute(*range(nd - 3), nd - 2, nd - 1, nd - 3)[..., None]  # [..., S, K, n_rx, 1]
    hh = torch.conj(h.transpose(-1, -2))  # [..., S, K, L, n_rx]
    a = torch.matmul(hh, h)  # H^H H
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)[..., None, None, None, None]
    a_reg = a + nv * torch.eye(n_layers, dtype=a.dtype, device=a.device)
    a_inv = _small_hermitian_inverse(a_reg)
    x = torch.matmul(a_inv, torch.matmul(hh, y))[..., 0]  # [..., S, K, L]
    mu = torch.clamp(torch.real(torch.diagonal(torch.matmul(a_inv, a), dim1=-2, dim2=-1)),
                     1e-6, 1.0 - 1e-6)
    sym = x / mu.to(x.dtype)
    sinr = mu / (1.0 - mu)
    return sym.movedim(-1, -3), sinr.movedim(-1, -3)


def _small_hermitian_inverse(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched [..., L, L] Hermitian positive-definite
    matrices, L in {1, 2, 3, 4}: direct cofactors for L<=3, 2x2 blockwise
    (Schur complement) for L=4."""
    n = a.shape[-1]
    if n == 1:
        return 1.0 / a
    if n == 2:
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        inv = torch.stack(
            [torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
             torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1)],
            dim=-2,
        )
        return inv / det[..., None, None]
    if n == 3:
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        c10 = a[..., 2, 1] * a[..., 0, 2] - a[..., 2, 2] * a[..., 0, 1]
        c11 = a[..., 2, 2] * a[..., 0, 0] - a[..., 2, 0] * a[..., 0, 2]
        c12 = a[..., 2, 0] * a[..., 0, 1] - a[..., 2, 1] * a[..., 0, 0]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        rows = [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ]
        return torch.stack(rows, dim=-2) / det[..., None, None]
    if n == 4:
        p, q = a[..., :2, :2], a[..., :2, 2:]
        r, s = a[..., 2:, :2], a[..., 2:, 2:]
        p_inv = _small_hermitian_inverse(p)
        sc_inv = _small_hermitian_inverse(s - r @ p_inv @ q)
        top_left = p_inv + p_inv @ q @ sc_inv @ r @ p_inv
        top_right = -(p_inv @ q @ sc_inv)
        bot_left = -(sc_inv @ r @ p_inv)
        return torch.cat([torch.cat([top_left, top_right], dim=-1),
                          torch.cat([bot_left, sc_inv], dim=-1)], dim=-2)
    raise NotImplementedError(f"layer count {n} > 4")
