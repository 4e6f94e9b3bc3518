"""The DM-RS channel estimator of a receive call, in float64 NumPy: a frozen
copy of the repository's design, recomputed from the received grid.

Per DM-RS port (comb offset port // 2, frequency OCC on odd ports): least
squares on the pilots against the reference's own DM-RS sequence; pair
estimates (e + o) / 2 or (e - o) / 2 over each OCC pair. The noise variance
is the least of the unbiased candidates that apply: twice the power of the
rejected OCC branch when the port's partner is not sent, the power of the
pair estimates' difference across DM-RS symbols, and a third of the power of
their second difference across the three pairs of a PRB. Interpolation over
frequency is a least-squares fit of a half-period DFT basis (6 terms when the
MCS is 8 or more, else 3; 3 at most on pair estimates) per bundle of 2 PRBs
(an odd last PRB alone), to the raw LS values when the partner port is not
sent and to the pair estimates when it is; over time it is linear between
DM-RS symbols, held flat outside them.
"""

from __future__ import annotations

import numpy as np

from isacbench.reference import rxchain, txchain


def interp_matrix(pattern, width: int, n_basis: int) -> np.ndarray:
    """[width, n_pilots]: h(k) = sum_m a_m exp(-2j pi k m / (2 width)), fit by
    least squares to the pilots at `pattern`."""
    p = np.asarray(pattern, np.float64)
    n_basis = max(min(n_basis, len(pattern)), 2)
    m = np.arange(n_basis)
    b = np.exp(-2j * np.pi * np.outer(p, m) / (2.0 * width))
    e = np.exp(-2j * np.pi * np.outer(np.arange(width), m) / (2.0 * width))
    return e @ np.linalg.pinv(b, rcond=1e-3)


def interp_time(hf: np.ndarray, dsyms, n_sym: int = 14) -> np.ndarray:
    """[..., n_dsym, K] -> [..., n_sym, K]."""
    d = np.asarray(dsyms)
    if d.size == 1:
        return np.repeat(hf[..., :1, :], n_sym, axis=-2)
    syms = np.arange(n_sym)
    right = np.clip(np.searchsorted(d, syms), 1, d.size - 1)
    left = right - 1
    wt = np.clip((syms - d[left]) / np.maximum(d[right] - d[left], 1), 0.0, 1.0)[:, None]
    return hf[..., left, :] * (1.0 - wt) + hf[..., right, :] * wt


def estimate(rx_c: np.ndarray, grant: dict) -> tuple:
    """rx_c [N, n_rx, 14, 12 n_prb] of N grants that share `grant`'s layout
    (their DM-RS from `grant['prbs_each']`) -> (H [N, 14, K, n_rx, L],
    noise variance [N])."""
    n, n_rx = rx_c.shape[:2]
    n_prb = len(grant["prbs_each"][0])
    dsyms = txchain.dmrs_symbols(grant["add_pos"], grant["sym_start"], grant["n_sym"])
    n_basis = 6 if grant["mcs"] >= 8 else 3
    ports = (0, 2, 1, 3)[:grant["n_layers"]]
    refs = np.stack([np.stack([rxchain.dmrs_base(grant["slot"], s, grant["n_id"], prbs)
                               for s in dsyms]) for prbs in grant["prbs_each"]])
    refs = refs[:, None]  # [N, 1, n_dsym, 6 n_prb]
    occ = np.tile([1.0, -1.0], 3 * n_prb)
    x = rx_c.astype(np.complex128)[:, :, list(dsyms)]
    nb_full, tail = n_prb // 2, n_prb % 2
    h_ports, cands = [], []
    for port in ports:
        delta = port // 2
        ls = x[..., delta::2] * np.conj(refs if port % 2 == 0 else refs * occ)
        e, o = ls[..., 0::2], ls[..., 1::2]
        pair = (e + o) / 2.0 if port % 2 == 0 else (e - o) / 2.0
        alone = (port ^ 1) not in ports
        if alone:
            rej = (e - o) / 2.0 if port % 2 == 0 else (e + o) / 2.0
            cands.append(np.mean(np.abs(rej) ** 2, axis=(1, 2, 3)) * 2.0)
        if len(dsyms) >= 2:
            cands.append(np.mean(np.abs(pair[..., 1:, :] - pair[..., :-1, :]) ** 2, axis=(1, 2, 3)))
        fp = pair.reshape(*pair.shape[:-1], -1, 3)
        cands.append(np.mean(np.abs(fp[..., 0] - 2.0 * fp[..., 1] + fp[..., 2]) ** 2,
                             axis=(1, 2, 3)) / 3.0)
        if alone:
            src, per_prb, off, nb = ls, 6, np.arange(0, 12, 2), n_basis
        else:
            src, per_prb, off, nb = pair, 3, np.array([1, 5, 9]), min(n_basis, 3)
        parts = []
        if nb_full:
            m = interp_matrix(np.concatenate([off, off + 12]) + delta, 24, nb)
            xb = src[..., :nb_full * 2 * per_prb].reshape(*src.shape[:-1], nb_full, 2 * per_prb)
            parts.append((xb @ m.T).reshape(*src.shape[:-1], nb_full * 24))
        if tail:
            m = interp_matrix(off + delta, 12, min(nb, 3))
            parts.append(src[..., nb_full * 2 * per_prb:] @ m.T)
        h_ports.append(interp_time(np.concatenate(parts, axis=-1), dsyms))
    h = np.stack(h_ports, axis=-1)  # [N, n_rx, 14, K, L]
    return h.transpose(0, 2, 3, 1, 4), np.maximum(np.min(np.stack(cands, -1), -1), 1e-10)
