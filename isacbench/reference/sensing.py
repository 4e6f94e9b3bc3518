"""The mono-static sensing post-pass after the range-Doppler map's inputs,
in float64 NumPy:

- the echo: each target in line of sight returns the transmitted waveform
  projected on its steering vector, delayed by ceil(2 r / c / T_s) samples
  (zero-filled), turned by its Doppler 2 v / lambda on the sample clock and
  by exp(-2j pi f_c s T_s), scaled by sqrt(G^2 lambda^2 sigma / ((4 pi)^3
  r^4)) (the radar equation), and received on the steering vector again;
  noise of power k T_eq f_s per sample. The waveform is CP-OFDM (TS 38.211
  §5.3.1, 1/N in the inverse FFT, subcarrier k on bin k - n_sc/2, the long CP
  on the first symbol of each half subframe), demodulated from
  floor(0.55 CP) samples into the CP with that shift turned back, FFT
  unscaled. Two numbers: the echo's amplitude fitted to the received grid
  (1 for a sound echo) as a z-score, and the power of the received grid less
  the reference's echo against the noise power, as a z-score, over 48
  subcarriers spread over the band;
- CA-CFAR (guard 2 x 2, training 1 x 1 around it, threshold N (P_fa^(-1/N) -
  1) times the training cells' mean, zero padding) on each antenna's power
  map inside the detection zone, detections of any antenna, then the cells
  that are a maximum of their 3 x 3 neighbourhood in the antennas' largest
  power, the 16 strongest, each giving range row * r_res and velocity
  (col - n_fft / 2) * v_res;
- MUSIC on the spatial covariance X X^H / n of the echo grid with as many
  signals as detections (1 to 4): 1 / |U_n^H a|^2 over the azimuth scan of
  the array's steering vectors, the 4 largest local maxima.
"""

from __future__ import annotations

import numpy as np

SPEED_OF_LIGHT = 299792458.0
BOLTZMANN = 1.380649e-23
CP_FRACTION = 0.55
TIE = 1e-5  # a power within this share of its threshold may fall either side
NOISE_SUBCARRIERS = 48


def _db2pow(x):
    return 10.0 ** (np.asarray(x, np.float64) / 10.0)


def symbol_layout(nfft: int, scs_khz: int, n_sym: int) -> tuple:
    """(start sample, CP length) of each of n_sym symbols from slot 0."""
    mu = int(round(np.log2(scs_khz / 15)))
    cp = 144 * nfft // 2048
    per_half_sf = 7 * 2**mu
    half_sf = int(round(nfft * scs_khz * 1e3 * 0.5e-3))
    extra = half_sf - per_half_sf * (nfft + cp)
    cps = np.asarray([cp + (extra if l % per_half_sf == 0 else 0) for l in range(n_sym)])
    starts = np.concatenate([[0], np.cumsum(cps + nfft)[:-1]])
    return starts, cps


def ula_steering(antenna, wavelength: float, az_deg) -> np.ndarray:
    """[n_ants, G]: element positions m d along the array, polarisations at
    one position, phase 2 pi m d sin(az) / lambda."""
    d = (antenna.spacing_meters if antenna.spacing_meters is not None
         else antenna.spacing * wavelength)
    m = np.repeat(np.arange(antenna.n_v), antenna.polarizations)[:, None] * d
    return np.exp(2j * np.pi * m * np.sin(np.deg2rad(np.atleast_1d(az_deg)))[None, :] / wavelength)


def targets(rec: dict) -> dict:
    """The radar's view of the targets, from the configuration."""
    gnb, tg = rec["gnb"], rec["target"]
    fc = gnb.dl_carrier_freq
    lam = SPEED_OF_LIGHT / fc
    fs = rec["nfft"] * gnb.scs_khz * 1e3
    pos = np.atleast_2d(np.asarray(rec["target_positions"], np.float64))
    rel = pos - np.asarray(gnb.position, np.float64)[None, :]
    rng = np.linalg.norm(rel, axis=-1)
    az = np.rad2deg(np.arctan2(rel[:, 1], rel[:, 0]))
    t = pos.shape[0]
    rcs = np.broadcast_to(np.asarray(tg.rcs_m2, np.float64), (t,))
    vel = np.broadcast_to(np.asarray(tg.velocity_ms, np.float64), (t,))
    g = _db2pow(gnb.rx_gain_db)
    lsf = np.sqrt(g * g * lam**2 * rcs / ((4 * np.pi) ** 3 * rng**4))
    shift = np.ceil(2.0 * rng / SPEED_OF_LIGHT * fs).astype(np.int64)
    coef = lsf * np.exp(-2j * np.pi * fc * shift / fs) * np.asarray(rec["target_los"], bool)
    teq = gnb.temperature_k + 290.0 * (_db2pow(gnb.noise_figure_db) - 1.0)
    return {"fs": fs, "lam": lam, "shift": shift, "fd": 2.0 * vel / lam, "coef": coef,
            "steer": ula_steering(gnb.antenna, lam, az), "n0": fs * BOLTZMANN * teq}


def radar_grid(rec: dict, n_sc: int) -> dict:
    """The map's bins and the CFAR zone (radarParams.m): n_ifft and n_fft the
    powers of two above the subcarriers and the frame's DL symbols, range bin
    c / (2 SCS n_ifft), velocity bin lambda / (2 T_sri n_fft) with T_sri =
    1 / SCS + ceil(n_sc / 8) T_s, the zone's edges the bins nearest the
    detection area's."""
    gnb = rec["gnb"]
    scs = gnb.scs_khz * 1e3
    fs = rec["nfft"] * scs
    lam = SPEED_OF_LIGHT / gnb.dl_carrier_freq
    n_sym = int(gnb.tdd.num_dl_slots / gnb.tdd.periodicity * rec["num_slots"] * 14)
    n_ifft = int(2 ** np.ceil(np.log2(max(n_sc, 2))))
    n_fft = int(2 ** np.ceil(np.log2(max(n_sym, 2))))
    r_res = SPEED_OF_LIGHT / (2 * scs * n_ifft)
    v_res = lam / (2 * (1.0 / scs + np.ceil(n_sc / 8) / fs) * n_fft)
    (rmin, rmax), (vmin, vmax) = gnb.radar.detection_area
    rg = np.arange(n_ifft) * r_res
    dg = (np.arange(n_fft) - n_fft / 2) * v_res
    zone = tuple(int(np.argmin(np.abs(g - v))) for g, v in
                 ((rg, rmin), (rg, rmax), (dg, vmin), (dg, vmax)))
    return {"n_ifft": n_ifft, "n_fft": n_fft, "r_res": r_res, "v_res": v_res, "zone": zone,
            "pfa": gnb.radar.pfa, "lam": lam, "az_scan": tuple(gnb.radar.azimuth_scan)}


def echo_grid(tx: np.ndarray, rec: dict, tg: dict) -> np.ndarray:
    """The noise-free echo grid [n_ants, n_sym, n_sc] of transmit grid tx
    [n_ants, n_sym, n_sc]."""
    n_ants, n_sym, n_sc = tx.shape
    nfft = rec["nfft"]
    starts, cps = symbol_layout(nfft, rec["gnb"].scs_khz, n_sym)
    total = int(starts[-1] + cps[-1] + nfft)
    bins = (np.arange(n_sc) - n_sc // 2) % nfft
    early = np.floor(cps * (1.0 - CP_FRACTION)).astype(np.int64)
    win = starts + cps - early
    out = np.zeros(tx.shape, np.complex128)
    for t, c in enumerate(tg["coef"]):
        if c == 0:
            continue
        q = np.einsum("a,ask->sk", tg["steer"][:, t], tx.astype(np.complex128))
        spec = np.zeros((n_sym, nfft), np.complex128)
        spec[:, bins] = q
        body = np.fft.ifft(spec, axis=-1)
        wave = np.zeros(total, np.complex128)
        for l in range(n_sym):
            wave[starts[l]:starts[l] + cps[l]] = body[l, nfft - cps[l]:]
            wave[starts[l] + cps[l]:starts[l] + cps[l] + nfft] = body[l]
        s = int(tg["shift"][t])
        moved = np.zeros(total, np.complex128)
        if s < total:
            moved[s:] = wave[:total - s]
        moved *= c * np.exp(2j * np.pi * tg["fd"][t] * np.arange(total) / tg["fs"])
        frames = moved[win[:, None] + np.arange(nfft)[None, :]]
        z = np.fft.fft(frames, axis=-1)[:, bins] * np.exp(2j * np.pi * np.outer(early, bins) / nfft)
        out += tg["steer"][:, t][:, None, None] * z[None]
    return out


def echo_numbers(rx: np.ndarray, tx: np.ndarray, rec: dict) -> dict:
    """{'echo': |a - 1| / sigma_a of the fitted amplitude a (absent without a
    target in line of sight), 'echo_noise': |z| of the residual's power}."""
    tg = targets(rec)
    y = echo_grid(tx, rec, tg)
    n0 = tg["n0"] * rec["nfft"]  # noise power per resource element
    rx = rx.astype(np.complex128)
    # the noise's power over NOISE_SUBCARRIERS subcarriers spread over the
    # band: z reads a bias of 0.2% as 1, not the whole grid's 0.03%
    ks = np.linspace(0, rx.shape[-1] - 1, min(NOISE_SUBCARRIERS, rx.shape[-1])).astype(np.int64)
    resid = rx[..., ks] - y[..., ks]
    out = {"echo_noise": abs(float(np.mean(np.abs(resid) ** 2)) / n0 - 1.0) * np.sqrt(resid.size)}
    energy = float(np.vdot(y, y).real)
    if energy > 0:
        a = np.vdot(y, rx) / energy
        out["echo"] = float(abs(a - 1.0) / np.sqrt(n0 / energy))
    return out


def _box_sum(p: np.ndarray, hr: int, hc: int) -> np.ndarray:
    """Sums over (2 hr + 1) x (2 hc + 1) windows of [..., R, C], zero padded."""
    r, c = p.shape[-2:]
    q = np.pad(p, [(0, 0)] * (p.ndim - 2) + [(hr, hr), (hc, hc)])
    out = np.zeros(p.shape, np.float64)
    for dr in range(2 * hr + 1):
        for dc in range(2 * hc + 1):
            out += q[..., dr:dr + r, dc:dc + c]
    return out


def cfar(rdm: np.ndarray, origin: tuple, zone: tuple, pfa: float, k: int = 16) -> dict:
    """CA-CFAR of the map rows/cols [origin, origin + shape) of every antenna
    (rdm [n_ants, R, C], zone = (r0, r1, c0, c1) inclusive, absolute).
    Returns sets of absolute (row, col): 'sure' (above the threshold by more
    than TIE), 'maybe' (within it), and the power map's maximum over antennas
    with its origin."""
    p = np.abs(rdm.astype(np.complex128)) ** 2
    n_train = 7 * 7 - 5 * 5
    alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
    thr = alpha * (_box_sum(p, 3, 3) - _box_sum(p, 2, 2)) / n_train
    r0, c0 = origin
    rows = r0 + np.arange(p.shape[-2])[:, None]
    cols = c0 + np.arange(p.shape[-1])[None, :]
    inside = (rows >= zone[0]) & (rows <= zone[1]) & (cols >= zone[2]) & (cols <= zone[3])
    pmax = p.max(axis=0)
    padded = np.pad(pmax, 1, constant_values=-np.inf)
    neigh = np.max([padded[1 + dr:1 + dr + pmax.shape[0], 1 + dc:1 + dc + pmax.shape[1]]
                    for dr in (-1, 0, 1) for dc in (-1, 0, 1)], axis=0)
    peak = (pmax >= neigh) & inside
    sure = np.any(p > thr * (1 + TIE), axis=0) & peak
    maybe = np.any(p > thr * (1 - TIE), axis=0) & peak
    order = np.argsort(-pmax[maybe], kind="stable")
    cand = [tuple(x) for x in np.argwhere(maybe)[order][:k]]
    top = {(r0 + r, c0 + c) for r, c in cand if sure[r, c]}
    return {"sure": top, "maybe": {(r0 + r, c0 + c) for r, c in np.argwhere(maybe)},
            "pmax": pmax}


def music(rx: np.ndarray, antenna, wavelength: float, az_scan: tuple, n_sig: int,
          k: int = 4) -> dict:
    """MUSIC on the echo grid [n_ants, n_sym, n_sc]: the scan's azimuths,
    the spectrum, its local maxima, the picks (scan indices, strongest
    first) and the count of leading signal eigenvalues split from the next
    by at least 1e-4 of the largest (the picks past it depend on the
    eigensolver's basis)."""
    x = rx.reshape(rx.shape[0], -1).astype(np.complex128)
    ra = x @ x.conj().T / x.shape[1]
    lam, vec = np.linalg.eigh(ra)
    scale, step = az_scan
    az = np.arange(-scale / 2, scale / 2 + step / 2, step)
    a = ula_steering(antenna, wavelength, az)
    un = vec[:, : ra.shape[0] - n_sig]
    spec = 1.0 / np.maximum(np.sum(np.abs(un.conj().T @ a) ** 2, axis=0), 1e-12)
    left = np.concatenate([spec[:1] - 1, spec[:-1]])
    right = np.concatenate([spec[1:], spec[-1:] - 1])
    peaks = np.nonzero((spec >= left) & (spec >= right))[0]
    picks = peaks[np.argsort(-spec[peaks], kind="stable")][:k]
    desc = lam[::-1]
    clean = [j for j in range(1, n_sig + 1) if (desc[j - 1] - desc[j]) / desc[0] >= 1e-4]
    return {"az": az, "spectrum": spec, "peaks": peaks, "picks": picks,
            "clean": max(clean, default=0)}
