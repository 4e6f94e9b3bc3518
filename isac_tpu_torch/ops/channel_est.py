"""Receiver DSP: DM-RS channel estimation, MMSE equalization and the timing
estimate (counterpart of isac_tpu/ops/channel_est.py).

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

from isac_tpu_torch.ops import dft


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def ls_estimate_port(
    rx_grid: torch.Tensor,  # [n_rx, n_sym, n_sc]
    ref_vals: np.ndarray,  # [n_pilot] complex, port's DM-RS values (w_f applied)
    sym_idx: np.ndarray,  # [n_dmrs_sym]
    sc_idx: np.ndarray,  # [n_pilot_sc] subcarrier indices (per DM-RS symbol)
) -> torch.Tensor:
    """Raw LS at pilot REs: H_ls[n_rx, n_dmrs_sym, n_pilot_sc]."""
    dev = rx_grid.device
    pilots = rx_grid[:, _idx(sym_idx, dev)][:, :, _idx(sc_idx, dev)]
    ref = torch.as_tensor(np.asarray(ref_vals).astype(np.complex64), device=dev)
    return pilots * torch.conj(ref)[None, None, :] / torch.clamp_min(torch.abs(ref) ** 2, 1e-12)


def occ2_decode(h_ls: torch.Tensor) -> tuple:
    """Split FD-OCC-2 pair estimates: input [..., 2n] alternating k'=0/1 ->
    (port_even [..., n], port_odd [..., n]) — averages/differences over pairs."""
    e = h_ls[..., 0::2]
    o = h_ls[..., 1::2]
    return (e + o) / 2.0, (e - o) / 2.0


def smooth_freq(h: torch.Tensor, window: int = 7) -> torch.Tensor:
    """Moving average over the last (subcarrier) axis with edge padding — the
    reference's channel-estimate averaging window (gNBPhy.m:935 uses [0 7])."""
    if window <= 1:
        return h
    pad = window // 2
    hp = torch.cat([h[..., :1].expand(*h.shape[:-1], pad), h,
                    h[..., -1:].expand(*h.shape[:-1], pad)], dim=-1)
    return hp.unfold(-1, window, 1).sum(dim=-1) * (1.0 / window)


def interp_to_grid(
    h_pilot: torch.Tensor,  # [..., n_dmrs_sym, n_pilot_sc]
    pilot_sc: np.ndarray,  # [n_pilot_sc] subcarrier positions of estimates
    dmrs_syms: np.ndarray,  # [n_dmrs_sym]
    n_sym: int,
    n_sc: int,
    bundle_sc: int | None = None,
) -> torch.Tensor:
    """Linear interpolation over subcarriers + linear over symbols to the full
    grid [..., n_sym, n_sc].

    bundle_sc: precoding-bundle width in subcarriers (PRG size * 12). The
    effective channel is discontinuous at bundle boundaries (a different
    precoder per PRG), so interpolation never mixes pilots across one."""
    dev = h_pilot.device
    sc = np.arange(n_sc)
    right = np.searchsorted(pilot_sc, sc)
    right = np.clip(right, 1, len(pilot_sc) - 1)
    left = right - 1
    x0, x1 = pilot_sc[left], pilot_sc[right]
    w = np.where(x1 > x0, (sc - x0) / np.maximum(x1 - x0, 1), 0.0)
    w = np.clip(w, 0.0, 1.0).astype(np.float32)
    if bundle_sc is not None:
        sc_grp = sc // bundle_sc
        lg, rg = pilot_sc[left] // bundle_sc, pilot_sc[right] // bundle_sc
        # pilot on the wrong side of a bundle boundary: snap to the in-bundle one
        w = np.where(rg != sc_grp, 0.0, w)
        w = np.where((lg != sc_grp) & (rg == sc_grp), 1.0, w).astype(np.float32)
    w_t = torch.as_tensor(w, device=dev)
    hf = (h_pilot[..., _idx(left, dev)] * (1.0 - w_t)
          + h_pilot[..., _idx(right, dev)] * w_t)  # [..., n_dmrs_sym, n_sc]
    return _interp_time(hf, np.asarray(dmrs_syms), n_sym)


def _mean_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.mean(x, dim=tuple(range(-n, 0)))


def estimate_channel_canonical(
    rx_c: torch.Tensor,  # [..., n_rx, 14, 12*n_prb] compact (allocated-PRB) grid
    refs: torch.Tensor,  # [..., n_dsym, 6*n_prb] base DM-RS sequence values
    ports: tuple,
    dsyms: tuple,
    n_prb: int,
    n_basis: int = 6,
    prg_prbs: int = 2,
):
    """Shape-static DM-RS estimator on the canonical compact grid, with
    per-bundle half-period DFT-basis interpolation over 2-PRB bundles (and an
    odd-PRB tail bundle). prg_prbs is accepted and unused, as in the
    reference: the estimation bundle stays 2 PRBs whatever the precoding
    granularity.

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


def estimate_channel_dmrs(
    rx_grid: torch.Tensor,  # [n_rx, n_sym, n_sc]
    slot: int,
    n_id: int,
    n_prb: int,
    prb_start: int,
    ports: tuple,
    dmrs_sym: tuple,
    freq_window: int = 7,
    prb_set: tuple | None = None,
    bundle_sc: int | None = None,
    interp: str = "linear",  # 'linear' (pair+linear) | 'dft' (per-bundle LS fit)
):
    """Practical DM-RS channel estimator on the full grid. prb_set overrides
    the contiguous (n_prb, prb_start) allocation for RBG-bitmap grants.

    Noise variance is the minimum over the unbiased candidate estimators that
    apply to the port configuration (each = nvar + a non-negative bias):
      (a) rejected-OCC-branch power, only when the port's FD-OCC partner is
          not transmitted;
      (b) time difference of pair estimates across DM-RS symbols;
      (c) second difference across adjacent frequency pairs within a PRB.

    Returns (H [n_sym, n_sc, n_rx, n_ports], noise_var scalar estimate).
    """
    from isac_tpu_torch.ops.dmrs import (
        dmrs_re_indices,
        dmrs_re_indices_prbs,
        dmrs_sequence,
        dmrs_values_for_prbs,
    )

    n_rx, n_sym, n_sc = rx_grid.shape
    dev = rx_grid.device
    sym_idx = np.asarray(dmrs_sym)
    active = set(ports)
    raw, pair_sc_of, ls_of, sc_of = {}, {}, {}, {}
    nvar_candidates = []
    for port in ports:
        if prb_set is not None:
            sc_idx = dmrs_re_indices_prbs(tuple(prb_set), port)
            refs = np.stack(
                [dmrs_values_for_prbs(slot, int(l), n_id, tuple(prb_set)) for l in sym_idx]
            )
        else:
            sc_idx = dmrs_re_indices(n_prb, prb_start, port)
            refs = np.stack(
                [dmrs_sequence(slot, int(l), n_id, n_prb, prb_start) for l in sym_idx]
            )  # [n_dmrs_sym, n_pilot]
        pilots = rx_grid[:, _idx(sym_idx, dev)][:, :, _idx(sc_idx, dev)]
        ls = pilots * torch.conj(torch.as_tensor(refs.astype(np.complex64), device=dev))[None]
        e, o = ls[..., 0::2], ls[..., 1::2]
        h_pair = (e + o) / 2.0 if port % 2 == 0 else (e - o) / 2.0
        partner = port + 1 if port % 2 == 0 else port - 1
        if partner not in active:
            rej = (e - o) / 2.0 if port % 2 == 0 else (e + o) / 2.0
            nvar_candidates.append(torch.mean(torch.abs(rej) ** 2) * 2.0)
        if h_pair.shape[1] >= 2:
            td = h_pair[:, 1:] - h_pair[:, :-1]
            nvar_candidates.append(torch.mean(torch.abs(td) ** 2))
        if h_pair.shape[-1] >= 3:
            fp = h_pair.reshape(*h_pair.shape[:-1], -1, 3)
            fd = fp[..., 0] - 2.0 * fp[..., 1] + fp[..., 2]
            nvar_candidates.append(torch.mean(torch.abs(fd) ** 2) / 3.0)
        raw[port] = h_pair
        pair_sc_of[port] = sc_idx[0::2] + 1  # pair center between the two REs
        ls_of[port] = ls
        sc_of[port] = sc_idx

    # FD-OCC cross-leakage cancellation for co-scheduled CDM pairs: with the
    # channel varying linearly across the OCC pair, the decode leaks the
    # partner port's slope; estimate each port's slope per PRB (3 pairs,
    # 4-SC spacing) and add it back.
    def _slope_per_prb(x):
        p = x.reshape(*x.shape[:-1], -1, 3)
        s0 = (p[..., 1] - p[..., 0]) / 4.0
        s1 = (p[..., 2] - p[..., 0]) / 8.0
        s2 = (p[..., 2] - p[..., 1]) / 4.0
        return torch.stack([s0, s1, s2], dim=-1).reshape(x.shape)

    est = dict(raw)
    for p0 in ports:
        p1 = p0 + 1 if p0 % 2 == 0 else p0 - 1
        if p0 % 2 == 0 and p1 in active and raw[p0].shape[-1] >= 3:
            est[p0] = raw[p0] + _slope_per_prb(raw[p1])
            est[p1] = raw[p1] + _slope_per_prb(raw[p0])

    h_ports = []
    for port in ports:
        partner = port + 1 if port % 2 == 0 else port - 1
        if interp == "dft" and partner not in active and port % 2 == 0:
            # raw per-RE LS (no pair averaging) -> per-bundle trigonometric fit
            sc_idx = sc_of[port]
            ib = bundle_sc if bundle_sc is not None else 24
            bid = sc_idx // ib
            h_freq = torch.zeros((n_rx, len(sym_idx), n_sc), dtype=torch.complex64, device=dev)
            pat_groups: dict = {}
            for b in np.unique(bid):
                sel = np.nonzero(bid == b)[0]
                w_b = int(min(ib, n_sc - b * ib))
                pat = (tuple((sc_idx[sel] - b * ib).tolist()), w_b)
                pat_groups.setdefault(pat, []).append((int(b), sel))
            for (pat, w_b), blist in pat_groups.items():
                m = torch.as_tensor(_dft_interp_matrix(pat, w_b), device=dev)
                sel_idx = np.stack([sel for _, sel in blist])  # [nb, n_pil]
                vals = ls_of[port][..., _idx(sel_idx, dev)]  # [n_rx, n_ds, nb, n_pil]
                out = torch.matmul(vals, m.T)  # [n_rx, n_ds, nb, w_b]
                sc_out = np.concatenate(
                    [np.arange(b * ib, b * ib + w_b) for b, _ in blist]
                )
                h_freq[..., _idx(sc_out, dev)] = out.reshape(*out.shape[:-2], -1)
            h_ports.append(_interp_time(h_freq, sym_idx, n_sym))
            continue
        h_pair = est[port]
        if bundle_sc is not None and freq_window > 1:
            # smooth within precoding bundles only (pairs_per_bundle = PRG_prbs*3)
            ppb = (bundle_sc // 12) * 3
            hp = h_pair.reshape(*h_pair.shape[:-1], -1, ppb)
            w_eff = min(freq_window, ppb)
            w_eff -= (w_eff + 1) % 2  # smooth_freq needs an odd window
            h_s = smooth_freq(hp, w_eff).reshape(h_pair.shape)
        else:
            h_s = smooth_freq(h_pair, freq_window)
        h_ports.append(interp_to_grid(
            h_s, pair_sc_of[port], sym_idx, n_sym, n_sc, bundle_sc=bundle_sc
        ))  # [n_rx, n_sym, n_sc]
    h = torch.stack(h_ports, dim=-1).permute(1, 2, 0, 3)  # [n_sym, n_sc, n_rx, n_ports]
    noise_var = torch.clamp_min(torch.amin(torch.stack(nvar_candidates)), 1e-10)
    return h, noise_var


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


def timing_estimate(
    waveform: torch.Tensor,  # [n_rx, n_samples]
    ref_waveform: torch.Tensor,  # [n_samples_ref]
    max_offset: int,
    threshold: float = 5.5,
) -> torch.Tensor:
    """Correlation timing estimate with the weak-peak skip rule
    (nrTimingEstimate + skipWeakTimingOffset.m: accept only if peak >= 5.5x
    mean). Returns a 0-d integer tensor (0 when the peak is weak)."""
    n = waveform.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + ref_waveform.shape[-1])))
    wf = dft.fft_auto(waveform, nfft, axis=-1)
    rf = dft.fft_auto(ref_waveform, nfft)
    corr = torch.abs(dft.ifft_auto(wf * torch.conj(rf)[None, :], axis=-1))
    mag = torch.sum(corr, dim=0)[: max_offset + 1]
    offset = torch.argmax(mag)
    ok = torch.max(mag) >= threshold * torch.mean(mag)
    return torch.where(ok, offset, torch.zeros_like(offset))
