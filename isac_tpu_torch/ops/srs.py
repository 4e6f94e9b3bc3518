"""SRS generation and estimation per TS 38.211 §6.4.1.4 (nrSRS/nrSRSIndices
analogue; counterpart of isac_tpu/ops/srs.py).

The reference configures per-UE full-band SRS: comb 4, last symbol (13),
2 ports, staggered periodicity (+communication/setupSRS.m:1-33). Base sequences
are low-PAPR Zadoff-Chu (§5.2.2); per-port comb offsets + cyclic shifts give
orthogonality.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.ops import dft


def _largest_prime_below(n: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        for d in range(2, int(np.sqrt(x)) + 1):
            if x % d == 0:
                return False
        return True

    for x in range(n, 1, -1):
        if is_prime(x):
            return x
    return 2


@lru_cache(maxsize=64)
def low_papr_base_sequence(m_zc: int, u: int = 0, v: int = 0) -> np.ndarray:
    """Low-PAPR sequence type 1: cyclic-extended Zadoff-Chu for length >= 36
    (TS 38.211 §5.2.2.1). For short lengths a ZC fallback is used."""
    n_zc = _largest_prime_below(m_zc)
    q_bar = n_zc * (u + 1) / 31.0
    q = int(np.floor(q_bar + 0.5)) + v * (1 if int(np.floor(2 * q_bar)) % 2 == 0 else -1)
    m = np.arange(n_zc)
    x_q = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
    return x_q[np.arange(m_zc) % n_zc]


def srs_sequence(m_sc: int, u: int = 0, cyclic_shift: int = 0, n_cs_max: int = 12) -> np.ndarray:
    """r(n) = e^{j alpha n} * base(n), alpha = 2 pi cs / n_cs_max."""
    base = low_papr_base_sequence(m_sc, u)
    alpha = 2.0 * np.pi * cyclic_shift / n_cs_max
    return base * np.exp(1j * alpha * np.arange(m_sc))


def srs_subcarriers(n_prb: int, comb: int = 4, comb_offset: int = 0, prb_start: int = 0) -> np.ndarray:
    """Comb-mapped subcarrier indices over the sounded band."""
    n_sc = n_prb * 12
    return prb_start * 12 + np.arange(comb_offset, n_sc, comb)


def srs_fill_grid(
    grid: np.ndarray,  # [n_ports, n_sym, n_sc]
    n_prb: int,
    symbol: int = 13,
    comb: int = 4,
    comb_offset: int = 0,
    prb_start: int = 0,
    u: int = 0,
):
    """Write SRS for each port (port p uses cyclic shift p). Returns (grid, mask)."""
    n_ports = grid.shape[0]
    ks = srs_subcarriers(n_prb, comb, comb_offset, prb_start)
    mask = np.zeros(grid.shape[-2:], bool)
    for p in range(n_ports):
        r = srs_sequence(len(ks), u, cyclic_shift=p * (12 // max(n_ports, 1)) % 12)
        grid[p, symbol, ks] = r
    mask[symbol, ks] = True
    return grid, mask


@lru_cache(maxsize=64)
def _srs_est_plan(
    n_prb: int, n_ports: int, comb: int, comb_offset: int, prb_start: int,
    u: int, device: torch.device,
):
    """Constants of the delay-domain port separation, on the device.

    Port p's cyclic shift cs_p rotates its channel by e^{j 2 pi cs_p n / 12}
    across comb subcarriers, which is a cyclic shift of cs_p*N/12 bins in the
    delay (IFFT) domain. Gating a window around each port's delay centre and
    de-rotating recovers each port exactly when the true delay spread fits
    the window — unbiased for frequency-selective channels, unlike a
    subcarrier moving average."""
    ks = srs_subcarriers(n_prb, comb, comb_offset, prb_start)
    n = len(ks)
    base_conj = np.conj(srs_sequence(n, u, 0)).astype(np.complex64)
    shifts = [p * (12 // max(n_ports, 1)) % 12 for p in range(n_ports)]
    centers = [int(round(s * n / 12.0)) % n for s in shifts]
    half = max(n // (2 * max(n_ports, 2)), 1)
    masks = np.zeros((n_ports, n), np.float32)
    for i, c in enumerate(centers):
        masks[i, (np.arange(-half, half + 1) + c) % n] = 1.0
    derot = np.exp(
        -2j * np.pi * np.outer(shifts, np.arange(n)) / 12.0
    ).astype(np.complex64)  # undo e^{j alpha_p n} after gating
    dev = {k: torch.as_tensor(v, device=device) for k, v in
           (("ks", ks.astype(np.int64)), ("base_conj", base_conj),
            ("masks", masks), ("derot", derot))}
    return dev, ks


def srs_estimate_ports(
    rx_grid: torch.Tensor,  # [n_rx, n_sym, n_sc]
    n_prb: int,
    n_ports: int,
    symbol: int = 13,
    comb: int = 4,
    comb_offset: int = 0,
    prb_start: int = 0,
    u: int = 0,
    per_prb: bool = False,
):
    """LS estimate at SRS REs with delay-domain cyclic-shift separation.

    Returns (H [n_re|n_prb, n_rx, n_ports], subcarrier indices [n_re]).
    per_prb=True averages the comb REs of each PRB."""
    c, ks = _srs_est_plan(n_prb, n_ports, comb, comb_offset, prb_start, u,
                          rx_grid.device)
    n = len(ks)
    y = rx_grid[:, symbol, c["ks"]]  # [n_rx, N]
    g = dft.ifft_auto(y * c["base_conj"], axis=-1)  # delay domain
    gp = g[:, None, :] * c["masks"][None]  # [n_rx, P, N]
    hp = dft.fft_auto(gp, axis=-1) * c["derot"][None]
    h = hp.permute(2, 0, 1)  # [N, n_rx, P]
    if per_prb:
        per = n // n_prb  # comb REs per PRB (e.g. 3 at comb 4)
        h = torch.mean(h[: n_prb * per].reshape(n_prb, per, *h.shape[1:]), dim=1)
    return h, ks
