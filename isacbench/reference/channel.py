"""CDL slot response, link budget and received grid, in float64.

The channel of a link is H[t, f, rx, tx] = sum_r c[rx, tx, r] exp(2j pi nu_r t)
exp(-2j pi f tau_r) (TR 38.901 §7.7.1 step 4, the ray form), evaluated
directly per ray at each OFDM symbol's start time and subcarrier frequency.
Symbol times follow TS 38.211 §5.3.1: a cyclic prefix of 144/2048 of the FFT
length, 16 * 64 * 2^mu basic time units longer at the first symbol of every
half subframe. Pathloss is TR 38.901 Table 7.4.1-1 UMa. The received grid is
in noise-normalised units: each transmitted resource element is scaled by
sqrt(P_re * G_rx / PL / N_re), N_re = k T_eq SCS.

What is taken from the program as given, because only the program's own
state holds it: the ray constants of each link (the CDL draw: cluster delays,
angles, coupling and initial phases, made from the scenario's seeds) and the
line of sight of each link (the city's blockage test).
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0
BOLTZMANN = 1.380649e-23


def db2pow(x):
    return 10.0 ** (np.asarray(x, np.float64) / 10.0)


def symbol_start_times(slot: int, nfft: int, scs_khz: int) -> np.ndarray:
    """Start time (s) of each of the 14 symbols of `slot`."""
    mu = int(round(np.log2(scs_khz / 15)))
    fs = nfft * scs_khz * 1e3
    cp = 144 * nfft // 2048
    per_half_sf = 7 * 2**mu
    half_sf = int(round(fs * 0.5e-3))
    extra = half_sf - per_half_sf * (nfft + cp)
    lens = np.asarray([nfft + cp + (extra if (slot * 14 + l) % per_half_sf == 0 else 0)
                       for l in range(14)], np.float64)
    slot_s = 1e-3 / 2**mu
    return slot * slot_s + np.concatenate([[0.0], np.cumsum(lens)[:-1]]) / fs


def subcarrier_freqs(ks: np.ndarray, n_sc: int, scs_khz: int) -> np.ndarray:
    """Baseband frequency of subcarriers `ks` of an n_sc grid centred on DC."""
    return (np.asarray(ks, np.float64) - n_sc // 2) * scs_khz * 1e3


def slot_response(links: list, t: np.ndarray, f: np.ndarray, device) -> torch.Tensor:
    """H [L, S, K, rx, tx] complex128 of `links` (objects with coeff [rx, tx, R],
    tau [R], nu [R]) at times t [S] and frequencies f [K], summed per ray."""
    out = []
    tt = torch.as_tensor(t, dtype=torch.float64, device=device)
    ff = torch.as_tensor(f, dtype=torch.float64, device=device)
    for link in links:
        c = torch.as_tensor(np.asarray(link.coeff), device=device).to(torch.complex128)
        tau = torch.as_tensor(np.asarray(link.tau, np.float64), device=device)
        nu = torch.as_tensor(np.asarray(link.nu, np.float64), device=device)
        pt = torch.polar(torch.ones_like(tt[:, None] * nu), 2 * np.pi * tt[:, None] * nu)
        pf = torch.polar(torch.ones_like(ff[:, None] * tau), -2 * np.pi * ff[:, None] * tau)
        out.append(torch.einsum("sr,kr,abr->skab", pt, pf, c))
    return torch.stack(out)


def pathloss_uma(bs, ut, fc_hz, los) -> np.ndarray:
    """TR 38.901 Table 7.4.1-1 UMa pathloss (dB), d3D and d2D floored at 1 m."""
    bs = np.asarray(bs, np.float64)
    ut = np.asarray(ut, np.float64)
    d3 = np.maximum(np.linalg.norm(ut - bs, axis=-1), 1.0)
    d2 = np.maximum(np.linalg.norm((ut - bs)[..., :2], axis=-1), 1.0)
    h_bs, h_ut = bs[..., 2], ut[..., 2]
    fg = fc_hz / 1e9
    d_bp = 4.0 * (h_bs - 1.0) * (h_ut - 1.0) * fc_hz / SPEED_OF_LIGHT
    pl1 = 28.0 + 22.0 * np.log10(d3) + 20.0 * np.log10(fg)
    pl2 = (28.0 + 40.0 * np.log10(d3) + 20.0 * np.log10(fg)
           - 9.0 * np.log10(d_bp**2 + (h_bs - h_ut) ** 2))
    pl_los = np.where(d2 <= d_bp, pl1, pl2)
    pl_nlos = 13.54 + 39.08 * np.log10(d3) + 20.0 * np.log10(fg) - 0.6 * (h_ut - 1.5)
    return np.where(np.asarray(los, bool), pl_los, np.maximum(pl_los, pl_nlos))


def _pathloss(cell, bs, ut, fc_hz, los):
    if cell.pathloss.model != "UMa" or cell.pathloss.shadow_fading:
        raise ValueError("the reference link budget knows UMa without shadow fading only")
    return pathloss_uma(bs, ut, fc_hz, los)


def noise_per_re(nf_db: float, temp_k: float, scs_khz: int) -> float:
    return BOLTZMANN * (temp_k + 290.0 * (db2pow(nf_db) - 1.0)) * scs_khz * 1e3


def dl_amplitude(src, dst, n_sc: int, los) -> np.ndarray:
    """Per-UE amplitude of cell `src`'s downlink at cell `dst`'s UEs [U]."""
    pl = _pathloss(dst, src.gnb.position, dst.ue_positions, src.gnb.dl_carrier_freq, los)
    p_re = db2pow(src.gnb.tx_power_dbm - 30.0) / n_sc
    n_re = noise_per_re(dst.ue.noise_figure_db, dst.ue.temperature_k, dst.gnb.scs_khz)
    return np.sqrt(p_re * db2pow(dst.ue.rx_gain_db - pl) / n_re)


def ul_amplitude(src, dst, ues, n_prbs, los) -> np.ndarray:
    """Amplitude of each uplink grant (UE `ues[g]` of cell `src` over
    `n_prbs[g]` PRBs) at cell `dst`'s gNB [G]."""
    pos = np.asarray(src.ue_positions)[np.asarray(ues, np.int64)]
    pl = _pathloss(src, dst.gnb.position, pos, dst.gnb.ul_carrier_freq,
                   np.asarray(los, bool)[np.asarray(ues, np.int64)])
    p = db2pow(src.ue.tx_power_dbm - 30.0) / (12.0 * np.asarray(n_prbs, np.float64))
    n_re = noise_per_re(dst.gnb.noise_figure_db, dst.gnb.temperature_k, dst.gnb.scs_khz)
    return np.sqrt(p * db2pow(dst.gnb.rx_gain_db - pl) / n_re)


def _c128(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.complex128)


def dl_received(rec: dict, device) -> tuple:
    """(H of the serving links [U, S, K, rx, tx], H of the destination's bank
    [S_src, U, ...] or None, received signal [U, rx, S, K]) of a DL record."""
    cell, ks = rec["cell"], rec["ks"]
    t = symbol_start_times(rec["slot"], rec["nfft"], cell.gnb.scs_khz)
    f = subcarrier_freqs(ks, rec["n_sc"], cell.gnb.scs_khz)
    h = slot_response(rec["links"], t, f, device)
    amp = torch.as_tensor(dl_amplitude(cell, cell, rec["n_sc"], cell.ue_los), device=device)
    y = torch.einsum("tsk,uskat->uask", _c128(rec["x"], device), h) * amp[:, None, None, None]
    hb = None
    net = rec.get("net")
    if net is not None:
        d, cells = net["d"], net["cells"]
        n_u = cell.ue_positions.shape[0]
        hb = slot_response(net["links"], t, f, device)
        hb = hb.reshape(len(cells), n_u, *hb.shape[1:])
        for s, src in enumerate(cells):
            xs = net["xs"][s]
            if s == d or xs is None or src.gnb.dl_carrier_freq != cell.gnb.dl_carrier_freq:
                continue
            los = net["cross_los"].get((d, s), np.zeros(n_u, bool))
            a = torch.as_tensor(dl_amplitude(src, cell, rec["n_sc"], los), device=device)
            y = y + torch.einsum("tsk,uskat->uask", _c128(xs, device), hb[s]) * a[:, None, None, None]
    return h, hb, y


def ul_received(rec: dict, device) -> tuple:
    """(H of the serving uplinks [U, S, K, rx, tx], received signal per grant
    [G, rx, S, K]) of a UL record; TDD co-channel cells reach the gNB through
    the reciprocal of their DL bank's links (the bank of the source cell,
    rows of this gNB)."""
    cell, ks = rec["cell"], rec["ks"]
    t = symbol_start_times(rec["slot"], rec["nfft"], cell.gnb.scs_khz)
    f = subcarrier_freqs(ks, rec["n_sc"], cell.gnb.scs_khz)
    h = slot_response(rec["links"], t, f, device)
    ues = [u for u, _ in rec["grants"]]
    amp = torch.as_tensor(ul_amplitude(cell, cell, ues, [n for _, n in rec["grants"]],
                                       cell.ue_los), device=device)
    idx = torch.as_tensor(np.asarray(ues, np.int64), device=device)
    y = torch.einsum("gtsk,gskat->gask", _c128(rec["x"], device), h[idx])
    y = y * amp[:, None, None, None]
    net = rec.get("net")
    if net is not None:
        d, cells = net["d"], net["cells"]
        for s, grids, grants in net["srcs"]:
            src = cells[s]
            if src.gnb.ul_carrier_freq != src.gnb.dl_carrier_freq:
                raise ValueError("the reference uplink interference knows TDD cells only")
            n_u = src.ue_positions.shape[0]
            links = net["bank_links"][s][d * n_u:(d + 1) * n_u]
            hb = slot_response(links, t, f, device)  # gNB d -> UEs of s: [U, S, K, ue, gnb]
            gues = [u for u, _ in grants]
            los = net["cross_los"].get((s, d), np.zeros(n_u, bool))
            a = torch.as_tensor(ul_amplitude(src, cell, gues, [n for _, n in grants], los),
                                device=device)
            gi = torch.as_tensor(np.asarray(gues, np.int64), device=device)
            term = torch.einsum("gtsk,gskta->ask", _c128(grids, device) * a[:, None, None, None],
                                hb[gi])
            y = y + term[None]
    return h, y
