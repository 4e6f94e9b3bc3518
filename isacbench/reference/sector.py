"""One CDL link whose gNB end is a sector's TRxP, in float64.

The ray constants of TR 38.901 §7.7.1 steps 1-4 (CDL-A and CDL-D, Tables
7.7.1-1 and 7.7.1-4, ray offsets of Table 7.5-3), with the gNB end of the
link made a sector's:

- §7.7.5.1 without spread scaling: the gNB end's ray azimuths and zeniths
  (departure on the downlink, arrival on the uplink) move by the link's
  geometric direction less the model's mean, the cluster-power-weighted
  circular mean of the table's cluster angles; the UE end is left as drawn;
- §7.1.3: the local angles of each moved ray at an array of bearing alpha
  (the boresight), downtilt beta and slant gamma = 0,
  theta' = arccos(cos b cos t + sin b sin t cos(p - a)),
  phi' = arg(cos b sin t cos(p - a) - sin b cos t + j sin t sin(p - a));
- Table 7.3-1 with 65 deg beamwidths: A = -min(-(A_V + A_H), 30) dB, the
  field of polarisation model 2, [cos zeta, sin zeta], scaled by 10^(A/20)
  (its 8 dBi maximum left out) and no polarisation rotation psi;
- the array phase of each gNB element from its position in the array's own
  coordinates and the ray's local direction (the same as the turned
  element's against the global direction).

The coefficient of ray r is c[rx, tx, r] = sqrt(P_r) F_rx^T M_r F_tx
a_rx a_tx, its delay the cluster's and its Doppler nu_r = r_rx . v / lambda
from the drawn (unmoved) arrival angles. The draw (the three permutations
of a cluster's ray offsets, AoA, ZoA, ZoD in that order, then its initial
phases) is numpy's ``default_rng(seed)``, so that the same seed gives the
program's rays; everything after the draw is torch float64 on the CPU.
Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0
F64 = torch.float64

OFFSETS = np.array([0.0447, -0.0447, 0.1413, -0.1413, 0.2492, -0.2492, 0.3715, -0.3715,
                    0.5129, -0.5129, 0.6797, -0.6797, 0.8844, -0.8844, 1.1481, -1.1481,
                    1.5195, -1.5195, 2.1551, -2.1551])

# normalised delay, power (dB), AoD, AoA, ZoD, ZoA (deg)
CDL_A = np.array([
    [0.0000, -13.4, -178.1, 51.3, 50.2, 125.4], [0.3819, 0.0, -4.2, -152.7, 93.2, 91.3],
    [0.4025, -2.2, -4.2, -152.7, 93.2, 91.3], [0.5868, -4.0, -4.2, -152.7, 93.2, 91.3],
    [0.4610, -6.0, 90.2, 76.6, 122.0, 94.0], [0.5375, -8.2, 90.2, 76.6, 122.0, 94.0],
    [0.6708, -9.9, 90.2, 76.6, 122.0, 94.0], [0.5750, -10.5, 121.5, -1.8, 150.2, 47.1],
    [0.7618, -7.5, -81.7, -41.9, 55.2, 56.5], [1.5375, -15.9, 158.4, 94.2, 26.4, 30.1],
    [1.8978, -6.6, -83.0, 51.9, 126.4, 58.8], [2.2242, -16.7, 134.8, -115.9, 171.6, 26.0],
    [2.1718, -12.4, -153.0, 26.6, 151.4, 49.2], [2.4942, -15.2, -172.0, 76.6, 157.2, 143.1],
    [2.5119, -10.8, -129.9, -7.0, 47.2, 117.4], [3.0582, -11.3, -136.0, -23.0, 40.4, 122.7],
    [4.0810, -12.7, 165.4, -47.2, 43.3, 123.2], [4.4579, -16.2, 148.4, 110.4, 161.8, 32.6],
    [4.5695, -18.3, 132.7, 144.5, 10.8, 27.2], [4.7966, -18.9, -118.6, 155.3, 16.7, 15.2],
    [5.0066, -16.6, -154.1, 102.0, 171.7, 146.0], [5.3043, -19.9, 126.5, -151.8, 22.7, 150.7],
    [9.6586, -29.7, -56.2, 55.2, 144.9, 156.1],
])
# the first row is the LoS ray (Table 7.7.1-4's specular path), the second
# its Laplacian cluster
CDL_D = np.array([
    [0.0000, -0.2, 0.0, -180.0, 98.5, 81.5], [0.0000, -13.5, 0.0, -180.0, 98.5, 81.5],
    [0.0350, -18.8, 89.2, 89.2, 85.5, 86.9], [0.6120, -21.0, 89.2, 89.2, 85.5, 86.9],
    [1.3630, -22.8, 89.2, 89.2, 85.5, 86.9], [1.4050, -17.9, 13.0, 163.0, 97.5, 79.4],
    [1.8040, -20.1, 13.0, 163.0, 97.5, 79.4], [2.5960, -21.9, 13.0, 163.0, 97.5, 79.4],
    [1.7750, -22.9, 34.6, -137.0, 98.5, 78.2], [4.0420, -27.8, -64.5, 74.5, 88.4, 73.6],
    [7.9370, -23.6, -32.9, 127.7, 91.3, 78.3], [9.4240, -24.8, 52.6, -119.6, 103.8, 87.0],
    [9.7080, -30.0, -132.1, -9.1, 80.3, 70.6], [12.5250, -27.7, 77.2, -83.8, 86.5, 72.9],
])

# table, (c_ASD, c_ASA, c_ZSD, c_ZSA), XPR dB, first row a LoS ray
PROFILES = {"CDL-A": (CDL_A, (5.0, 11.0, 3.0, 3.0), 10.0, False),
            "CDL-D": (CDL_D, (5.0, 8.0, 3.0, 3.0), 11.0, True)}


def _rad(x) -> torch.Tensor:
    return torch.deg2rad(torch.as_tensor(x, dtype=F64))


def _direction(zen: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.sin(zen) * torch.cos(az), torch.sin(zen) * torch.sin(az),
                        torch.cos(zen)], -1)


def circular_mean(angles_deg, powers) -> torch.Tensor:
    """The power-weighted circular mean of angles, rad."""
    w = torch.as_tensor(powers, dtype=F64)
    a = _rad(angles_deg)
    return torch.atan2((w * torch.sin(a)).sum(), (w * torch.cos(a)).sum())


def local_angles(zen: torch.Tensor, az: torch.Tensor, bearing: float, downtilt: float) -> tuple:
    """(theta', phi') rad of global angles at an array of bearing alpha and
    downtilt beta (rad), slant 0 (TR 38.901 eq. 7.1-7, 7.1-8)."""
    cb, sb = np.cos(downtilt), np.sin(downtilt)
    rel = az - bearing
    th = torch.arccos((cb * torch.cos(zen) + sb * torch.sin(zen) * torch.cos(rel)).clamp(-1, 1))
    ph = torch.atan2(torch.sin(zen) * torch.sin(rel),
                     cb * torch.sin(zen) * torch.cos(rel) - sb * torch.cos(zen))
    return th, ph


def pattern_db(theta_deg: torch.Tensor, phi_deg: torch.Tensor) -> torch.Tensor:
    """TR 38.901 Table 7.3-1, theta_3dB = phi_3dB = 65 deg, SLA_V = A_max =
    30 dB, without G_max."""
    a_v = -torch.clamp(12.0 * ((theta_deg - 90.0) / 65.0) ** 2, max=30.0)
    a_h = -torch.clamp(12.0 * (phi_deg / 65.0) ** 2, max=30.0)
    return -torch.clamp(-(a_v + a_h), max=30.0)


def _draw(profile: str, seed: int) -> dict:
    """The rays of a link in the draw's order: cluster index, angles (deg)
    and initial phases, numpy's default_rng(seed)."""
    table, (c_asd, c_asa, c_zsd, c_zsa), _, los = PROFILES[profile]
    rng = np.random.default_rng(seed)
    rays = {k: [] for k in ("cl", "aod", "aoa", "zod", "zoa", "phase", "los")}
    for n, row in enumerate(table):
        specular = los and n == 0
        m = 1 if specular else OFFSETS.size
        off = np.zeros(1) if specular else OFFSETS
        p_aoa, p_zoa, p_zod = rng.permutation(m), rng.permutation(m), rng.permutation(m)
        rays["cl"].append(np.full(m, n))
        rays["aod"].append(row[2] + c_asd * off)
        rays["aoa"].append(row[3] + c_asa * off[p_aoa])
        rays["zod"].append(row[4] + c_zsd * off[p_zod])
        rays["zoa"].append(row[5] + c_zsa * off[p_zoa])
        rays["phase"].append(np.zeros((1, 4)) if specular else rng.uniform(-np.pi, np.pi, (m, 4)))
        rays["los"].append(np.full(m, specular))
    return {k: np.concatenate(v) for k, v in rays.items()}


def sector_link(profile: str, delay_spread_ns: float, fc_hz: float, tx_positions, rx_positions,
                ue_velocity, seed: int, boresight_deg: float, downtilt_deg: float,
                ue_azimuth_deg: float, ue_zenith_deg: float, gnb_end: str = "tx") -> tuple:
    """(coeff [rx, tx, R] complex128, tau [R], nu [R]) of a link whose gNB
    end (`gnb_end`: "tx" on the downlink, "rx" on the uplink) is a sector's
    TRxP of boresight and downtilt (deg), towards a UE at the global azimuth
    and zenith (deg) from it. Element positions in metres, [n, 3], the gNB's
    in its array's own coordinates (broadside +x); the UE velocity [3] m/s or
    a speed along x; slants +-45 deg alternating over each array."""
    table, _, xpr_db, _ = PROFILES[profile]
    rays = _draw(profile, seed)
    lam = SPEED_OF_LIGHT / fc_hz
    p_cl = 10.0 ** (table[:, 1] / 10.0)
    p_cl = p_cl / p_cl.sum()
    cl = rays["cl"]
    m = np.bincount(cl)
    tau = table[cl, 0] * (delay_spread_ns * 1e-9)
    power = torch.as_tensor(p_cl[cl] / m[cl], dtype=F64)

    # the drawn directions; the gNB end's moved towards the UE (§7.7.5.1)
    ang = {k: _rad(rays[k]) for k in ("aod", "aoa", "zod", "zoa")}
    r_rx_drawn = _direction(ang["zoa"], ang["aoa"])
    az_key, zen_key, col_az, col_zen = (("aod", "zod", 2, 4) if gnb_end == "tx"
                                        else ("aoa", "zoa", 3, 5))
    az = ang[az_key] - circular_mean(table[:, col_az], p_cl) + _rad(ue_azimuth_deg)
    zen = ang[zen_key] - circular_mean(table[:, col_zen], p_cl) + _rad(ue_zenith_deg)
    th, ph = local_angles(zen, az, np.deg2rad(boresight_deg), np.deg2rad(downtilt_deg))
    gain = 10.0 ** (pattern_db(torch.rad2deg(th), torch.rad2deg(ph)) / 20.0)
    r_gnb_local = _direction(th, ph)
    ang[az_key], ang[zen_key] = az, zen

    def field(n: int) -> torch.Tensor:
        zeta = torch.full((n,), np.pi / 4, dtype=F64)
        zeta[1::2] = -zeta[1::2]
        return torch.stack([torch.cos(zeta), torch.sin(zeta)], -1)  # [n, 2]

    tx_pos = torch.as_tensor(np.asarray(tx_positions), dtype=F64)
    rx_pos = torch.as_tensor(np.asarray(rx_positions), dtype=F64)
    r_tx = r_gnb_local if gnb_end == "tx" else _direction(ang["zod"], ang["aod"])
    r_rx = r_gnb_local if gnb_end == "rx" else _direction(ang["zoa"], ang["aoa"])
    a_tx = torch.exp(2j * np.pi * (tx_pos @ r_tx.T) / lam)  # [tx, R]
    a_rx = torch.exp(2j * np.pi * (rx_pos @ r_rx.T) / lam)  # [rx, R]

    phase = torch.as_tensor(rays["phase"], dtype=F64)
    x = torch.as_tensor(np.where(rays["los"], 0.0, 10.0 ** (-xpr_db / 20.0)), dtype=F64)
    coupling = torch.stack([
        torch.stack([torch.exp(1j * phase[:, 0]), x * torch.exp(1j * phase[:, 1])], -1),
        torch.stack([x * torch.exp(1j * phase[:, 2]), torch.exp(1j * phase[:, 3])], -1),
    ], -2)  # [R, 2 (theta, phi) rx, 2 tx]
    f_tx = field(tx_pos.shape[0]).to(torch.complex128)
    f_rx = field(rx_pos.shape[0]).to(torch.complex128)
    pol = torch.einsum("ai,rij,bj->abr", f_rx, coupling, f_tx)  # [rx, tx, R]
    coeff = torch.sqrt(power) * gain * pol * a_rx[:, None, :] * a_tx[None, :, :]

    vel = np.asarray(ue_velocity, np.float64)
    vel = np.array([float(vel), 0.0, 0.0]) if vel.ndim == 0 else vel
    nu = (r_rx_drawn @ torch.as_tensor(vel, dtype=F64)) / lam
    return coeff, torch.as_tensor(tau, dtype=F64), nu
