"""TR 38.901 §7.4.1 pathloss models + free-space (MATLAB nrPathLoss / fspl analogue).

Reference call sites: +communication/+pathlossModels/config5GNRModels.m:1-38,
configFreeSpaceModel.m:1-8. LoS flag comes from the topology
layer. Host-side numpy (link budgets are setup/per-slot scalars); all functions
are vectorized over link dimensions. The port's own copy of
isac_tpu/ops/pathloss.py.
"""

from __future__ import annotations

import numpy as np

from isac_tpu_torch.utils.geometry import SPEED_OF_LIGHT


def fspl(distance_m, fc_hz):
    """Free-space pathloss 20 log10(4 pi d / lambda) dB (configFreeSpaceModel.m)."""
    lam = SPEED_OF_LIGHT / fc_hz
    d = np.maximum(np.asarray(distance_m, np.float64), 1.0)
    return 20.0 * np.log10(4.0 * np.pi * d / lam)


def _d3d_d2d(bs_pos, ut_pos):
    bs = np.asarray(bs_pos, np.float64)
    ut = np.asarray(ut_pos, np.float64)
    d3 = np.linalg.norm(ut - bs, axis=-1)
    d2 = np.linalg.norm((ut - bs)[..., :2], axis=-1)
    return np.maximum(d3, 1.0), np.maximum(d2, 1.0)


def _break_dist(h_bs, h_ut, fc, h_e=1.0):
    return 4.0 * (h_bs - h_e) * (h_ut - h_e) * fc / SPEED_OF_LIGHT


def pathloss_uma(bs_pos, ut_pos, fc_hz, los):
    """UMa (Table 7.4.1-1). los: bool array."""
    d3, d2 = _d3d_d2d(bs_pos, ut_pos)
    h_bs = np.asarray(bs_pos, np.float64)[..., 2]
    h_ut = np.asarray(ut_pos, np.float64)[..., 2]
    fg = fc_hz / 1e9
    dbp = _break_dist(h_bs, h_ut, fc_hz)
    pl1 = 28.0 + 22.0 * np.log10(d3) + 20.0 * np.log10(fg)
    pl2 = (
        28.0 + 40.0 * np.log10(d3) + 20.0 * np.log10(fg)
        - 9.0 * np.log10(dbp**2 + (h_bs - h_ut) ** 2)
    )
    pl_los = np.where(d2 <= dbp, pl1, pl2)
    pl_nlos = 13.54 + 39.08 * np.log10(d3) + 20.0 * np.log10(fg) - 0.6 * (h_ut - 1.5)
    return np.where(np.asarray(los, bool), pl_los, np.maximum(pl_los, pl_nlos))


def pathloss_umi(bs_pos, ut_pos, fc_hz, los):
    """UMi street canyon (Table 7.4.1-1)."""
    d3, d2 = _d3d_d2d(bs_pos, ut_pos)
    h_bs = np.asarray(bs_pos, np.float64)[..., 2]
    h_ut = np.asarray(ut_pos, np.float64)[..., 2]
    fg = fc_hz / 1e9
    dbp = _break_dist(h_bs, h_ut, fc_hz)
    pl1 = 32.4 + 21.0 * np.log10(d3) + 20.0 * np.log10(fg)
    pl2 = (
        32.4 + 40.0 * np.log10(d3) + 20.0 * np.log10(fg)
        - 9.5 * np.log10(dbp**2 + (h_bs - h_ut) ** 2)
    )
    pl_los = np.where(d2 <= dbp, pl1, pl2)
    pl_nlos = 35.3 * np.log10(d3) + 22.4 + 21.3 * np.log10(fg) - 0.3 * (h_ut - 1.5)
    return np.where(np.asarray(los, bool), pl_los, np.maximum(pl_los, pl_nlos))


def pathloss_rma(bs_pos, ut_pos, fc_hz, los, h_building=5.0, w_street=20.0):
    """RMa (Table 7.4.1-1)."""
    d3, d2 = _d3d_d2d(bs_pos, ut_pos)
    h_bs = np.asarray(bs_pos, np.float64)[..., 2]
    h_ut = np.asarray(ut_pos, np.float64)[..., 2]
    fg = fc_hz / 1e9
    h = h_building
    dbp = 2.0 * np.pi * h_bs * h_ut * fc_hz / SPEED_OF_LIGHT

    def pl1(d):
        return (
            20.0 * np.log10(40.0 * np.pi * d * fg / 3.0)
            + np.minimum(0.03 * h**1.72, 10.0) * np.log10(d)
            - np.minimum(0.044 * h**1.72, 14.77)
            + 0.002 * np.log10(h) * d
        )

    pl_los = np.where(d2 <= dbp, pl1(d3), pl1(dbp) + 40.0 * np.log10(d3 / dbp))
    pl_nlos = (
        161.04
        - 7.1 * np.log10(w_street)
        + 7.5 * np.log10(h)
        - (24.37 - 3.7 * (h / h_bs) ** 2) * np.log10(h_bs)
        + (43.42 - 3.1 * np.log10(h_bs)) * (np.log10(d3) - 3.0)
        + 20.0 * np.log10(fg)
        - (3.2 * np.log10(11.75 * h_ut) ** 2 - 4.97)
    )
    return np.where(np.asarray(los, bool), pl_los, np.maximum(pl_los, pl_nlos))


def pathloss_inh(bs_pos, ut_pos, fc_hz, los):
    """InH office (Table 7.4.1-1)."""
    d3, _ = _d3d_d2d(bs_pos, ut_pos)
    fg = fc_hz / 1e9
    pl_los = 32.4 + 17.3 * np.log10(d3) + 20.0 * np.log10(fg)
    pl_nlos = 38.3 * np.log10(d3) + 17.30 + 24.9 * np.log10(fg)
    return np.where(np.asarray(los, bool), pl_los, np.maximum(pl_los, pl_nlos))


def pathloss_inf(bs_pos, ut_pos, fc_hz, los, subscenario="SL"):
    """InF (Table 7.4.1-1): sub-scenarios SL/DL/SH/DH."""
    d3, _ = _d3d_d2d(bs_pos, ut_pos)
    fg = fc_hz / 1e9
    pl_los = 31.84 + 21.50 * np.log10(d3) + 19.00 * np.log10(fg)
    nlos = {
        "SL": 33.0 + 25.5 * np.log10(d3) + 20.0 * np.log10(fg),
        "DL": 18.6 + 35.7 * np.log10(d3) + 20.0 * np.log10(fg),
        "SH": 32.4 + 23.0 * np.log10(d3) + 20.0 * np.log10(fg),
        "DH": 33.63 + 21.9 * np.log10(d3) + 20.0 * np.log10(fg),
    }[subscenario]
    if subscenario == "DL":
        nlos = np.maximum(nlos, 33.0 + 25.5 * np.log10(d3) + 20.0 * np.log10(fg))
    return np.where(np.asarray(los, bool), pl_los, np.maximum(pl_los, nlos))


def pathloss(model: str, bs_pos, ut_pos, fc_hz, los):
    """Dispatch by model name (+pathLossModels/parameters.m vocabulary)."""
    m = model.lower()
    if m == "fspl":
        d3, _ = _d3d_d2d(bs_pos, ut_pos)
        return fspl(d3, fc_hz)
    if m == "uma":
        return pathloss_uma(bs_pos, ut_pos, fc_hz, los)
    if m == "umi":
        return pathloss_umi(bs_pos, ut_pos, fc_hz, los)
    if m == "rma":
        return pathloss_rma(bs_pos, ut_pos, fc_hz, los)
    if m == "inh":
        return pathloss_inh(bs_pos, ut_pos, fc_hz, los)
    if m.startswith("inf"):
        sub = model.split("-")[1].upper() if "-" in model else "SL"
        return pathloss_inf(bs_pos, ut_pos, fc_hz, los, sub)
    raise ValueError(f"unknown pathloss model '{model}'")
