"""Radar estimation parameters: SNR budget, 2D-FFT resolutions, steering vectors.

Counterpart of +sensing/radarParams.m:1-146. All values are derived
host-side (target geometry is static scenario config), entering device code as
constants; float64 numpy keeps the carrier-phase constants exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from isac_tpu_torch.config.params import ULA, UPA
from isac_tpu_torch.utils.geometry import BOLTZMANN, SPEED_OF_LIGHT, cart2sph, db2pow, pow2db


@dataclass(frozen=True, eq=False)  # eq=False: identity hash (ndarray fields),
class RadarDerived:  # so an instance can key the per-device constant caches
    """Everything the sensing chain needs (radarParams.m output struct)."""

    fc: float
    fs: float
    tsri: float  # whole-OFDM-symbol duration (Tofdm + Tcp)
    n0: float  # noise power, fs * k * Teq
    n_tx_ants: int
    n_targets: int
    range_m: np.ndarray  # [T]
    velocity_ms: np.ndarray  # [T]
    azimuth_deg: np.ndarray  # [T]
    elevation_deg: np.ndarray  # [T]
    large_scale_fading: np.ndarray  # sqrt(Pr/Pt), [T]
    snr_db: np.ndarray  # [T]
    tx_power_dbm: float
    pfa: float
    n_ifft: int
    r_res: float
    r_max: float
    n_fft: int
    v_res: float
    v_max: float
    steering: np.ndarray  # [n_ants, T] complex128
    antenna: object
    cfar_zone: tuple  # ((rmin, rmax), (vmin, vmax))
    azimuth_scan: tuple = (360.0, 1.0)  # scale, granularity (deg)
    elevation_scan: tuple = (180.0, 1.0)
    # ground truth sorted by descending SNR (radarParams.m:127-145)
    truth: tuple = ()


def steering_vector(antenna, wavelength: float, az_deg, el_deg) -> np.ndarray:
    """Array steering vectors, [n_ants, ...]. Mirrors radarParams.m:81-118:
    ULA a_m = exp(2j pi m d sin(az)/lambda); UPA
    a_{m,n} = exp(2j pi sin(el) (x_m cos(az) + y_n sin(az))/lambda)."""
    az = np.deg2rad(np.asarray(az_deg, dtype=np.float64))
    el = np.deg2rad(np.asarray(el_deg, dtype=np.float64))
    if isinstance(antenna, UPA):
        x = (np.arange(antenna.n_v) * antenna.d_v * wavelength)  # X-axis elements
        y = (np.arange(antenna.n_h) * antenna.d_h * wavelength)
        phase = (
            np.sin(el)[None, None, ...]
            * (
                x[:, None, ...] * np.cos(az)[None, None, ...]
                + y[None, :, ...] * np.sin(az)[None, None, ...]
            )
            / wavelength
        )
        a = np.exp(2j * np.pi * phase)  # [nV, nH, ...]
        a = a.reshape(antenna.n_v * antenna.n_h, *np.shape(az))
        reps = antenna.polarizations * antenna.n_pv * antenna.n_ph
        return np.concatenate([a] * reps, axis=0)
    # ULA (radarParams.m:107-118): element positions m*d, phase by azimuth only.
    # Cross-polarized pairs are CO-LOCATED: a 2-pol ULA with n_v positions has
    # n_v distinct phase centers repeated per polarization (aperture = n_v*d,
    # NOT num_elements*d — the polarization dimension adds no spatial aperture).
    d = antenna.element_spacing(wavelength)
    m = np.repeat(np.arange(antenna.n_v), antenna.polarizations)[:, None] * d
    return np.exp(2j * np.pi * m * np.sin(az)[None, ...] / wavelength)


def derive_radar_params(
    gnb,
    carrier,
    target_positions: np.ndarray,
    target_rcs: np.ndarray,
    target_velocity: np.ndarray,
    num_slots: int,
) -> RadarDerived:
    """Port of the radarParams.m math (file:line cites inline)."""
    info = carrier.ofdm
    pos = np.atleast_2d(np.asarray(target_positions, dtype=np.float64))
    n_targets = pos.shape[0]
    rel = pos - np.asarray(gnb.position, dtype=np.float64)[None, :]
    az_rad, el_rad, rng = cart2sph(rel[:, 0], rel[:, 1], rel[:, 2])  # (:12-14)
    az, el = np.rad2deg(az_rad), np.rad2deg(el_rad)

    tdd = gnb.tdd
    dl_ratio = tdd.num_dl_slots / tdd.periodicity  # (:27-29)
    n_dl_slots = dl_ratio * num_slots
    n_sc = carrier.n_sc
    n_sym = int(n_dl_slots * info.symbols_per_slot)

    c = SPEED_OF_LIGHT
    fc = gnb.dl_carrier_freq
    scs = carrier.scs_khz * 1e3
    lam = c / fc
    fs = info.sample_rate
    ts = 1.0 / fs
    t_ofdm = 1.0 / scs
    t_cp = ts * np.ceil(n_sc / 8)  # (:36) reference's CP-duration approximation
    tsri = t_ofdm + t_cp

    nf = db2pow(gnb.noise_figure_db)
    teq = gnb.temperature_k + 290.0 * (nf - 1.0)  # (:42)
    n0 = fs * BOLTZMANN * teq
    pt = db2pow(gnb.tx_power_dbm - 30.0) * np.sqrt(
        info.nfft**2 / (n_sc * gnb.num_tx_ants)
    )  # (:44) — includes the OFDM amplitude-scaling convention
    ar = db2pow(gnb.rx_gain_db)
    at = ar

    rcs = np.asarray(target_rcs, dtype=np.float64)
    vel = np.asarray(target_velocity, dtype=np.float64)
    pr = pt * at * ar * (lam**2 * rcs) / ((4 * np.pi) ** 3 * rng**4)  # (:50)
    snr = pr / n0
    snr_db = pow2db(np.maximum(snr, 1e-300))

    n_ifft = int(2 ** np.ceil(np.log2(max(n_sc, 2))))  # (:67)
    r_res = c / (2 * scs * n_ifft)
    r_max = c / (2 * scs)
    n_fft = int(2 ** np.ceil(np.log2(max(n_sym, 2))))  # (:74)
    v_res = lam / (2 * tsri * n_fft)
    v_max = lam / (2 * tsri)

    steer = steering_vector(gnb.antenna, lam, az, el)  # [n_ants, T]

    order = np.argsort(-snr_db)
    truth = tuple(
        {
            "ID": i + 1,
            "Range": float(rng[j]),
            "Velocity": float(vel[j]),
            "Elevation": float(el[j]),
            "Azimuth": float(az[j]),
            "snrdB": float(snr_db[j]),
        }
        for i, j in enumerate(order)
    )

    return RadarDerived(
        fc=fc,
        fs=fs,
        tsri=tsri,
        n0=n0,
        n_tx_ants=gnb.num_tx_ants,
        n_targets=n_targets,
        range_m=rng,
        velocity_ms=vel,
        azimuth_deg=az,
        elevation_deg=el,
        large_scale_fading=np.sqrt(pr / pt),
        snr_db=snr_db,
        tx_power_dbm=gnb.tx_power_dbm,
        pfa=gnb.radar.pfa,
        n_ifft=n_ifft,
        r_res=r_res,
        r_max=r_max,
        n_fft=n_fft,
        v_res=v_res,
        v_max=v_max,
        steering=steer,
        antenna=gnb.antenna,
        cfar_zone=tuple(map(tuple, gnb.radar.detection_area)),
        azimuth_scan=tuple(gnb.radar.azimuth_scan),
        elevation_scan=tuple(gnb.radar.elevation_scan),
        truth=truth,
    )
