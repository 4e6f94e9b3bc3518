"""Sensing post-processing: estimate-vs-truth RMSE and detection ROC.

Equivalents of +sensing/+postProcessing/getRMSE.m:1-73 and
+sensing/+detection/getPd.m:1-24 (rocpfa). Host-side numpy (post-sim analysis).

Note: the reference reads `tgtRealPos` while radarParams writes `targetRealPos`
(a latent field-name bug, SURVEY §2.6); here truth flows in explicitly.
"""

from __future__ import annotations

import numpy as np

from isac_tpu_torch.config.params import ULA
from isac_tpu_torch.ops.sensing.radar_params import RadarDerived


def _fold_ula_azimuth(az_deg: np.ndarray) -> np.ndarray:
    """Fold an azimuth into a ULA's unambiguous sector [-90, 90] deg.

    A 1D ULA only observes sin(az): angles az and 180-az are physically
    indistinguishable (mirror ambiguity). Errors are scored in the folded
    domain so a correct mirror estimate is not penalized by ~180 deg."""
    return np.degrees(np.arcsin(np.clip(np.sin(np.radians(az_deg)), -1.0, 1.0)))


def get_rmse(est: dict, params: RadarDerived) -> dict:
    """Match detections to ground truth within r_res and compute per-dimension RMSE.

    est: dict with rngEst/velEst (+ optional aziEst/eleEst) arrays (NaN = invalid).
    Returns per-matched-detection errors and aggregate RMSEs.
    """
    rng_est = np.asarray(est["rngEst"], dtype=np.float64)
    vel_est = np.asarray(est.get("velEst", np.full_like(rng_est, np.nan)), dtype=np.float64)
    azi_est = np.asarray(est.get("aziEst", np.full_like(rng_est, np.nan)), dtype=np.float64)
    ele_est = np.asarray(est.get("eleEst", np.full_like(rng_est, np.nan)), dtype=np.float64)
    valid = np.isfinite(rng_est)
    is_ula = isinstance(params.antenna, ULA)
    if is_ula:
        azi_est = _fold_ula_azimuth(azi_est)

    truth = params.truth
    matches = []
    used = set()
    for i in np.where(valid)[0]:
        best, best_err = None, np.inf
        for t_i, t in enumerate(truth):
            if t_i in used:
                continue
            err = abs(rng_est[i] - t["Range"])
            if err < best_err:
                best, best_err = t_i, err
        if best is not None and best_err <= params.r_res * 2.0:  # match threshold
            used.add(best)
            t = truth[best]
            t_azi = _fold_ula_azimuth(t["Azimuth"]) if is_ula else t["Azimuth"]
            matches.append(
                {
                    "det": int(i),
                    "rngErr": rng_est[i] - t["Range"],
                    "velErr": (vel_est[i] - t["Velocity"]) if np.isfinite(vel_est[i]) else np.nan,
                    "aziErr": (azi_est[i] - t_azi) if np.isfinite(azi_est[i]) else np.nan,
                    "eleErr": (ele_est[i] - t["Elevation"]) if np.isfinite(ele_est[i]) else np.nan,
                }
            )

    def rmse(key):
        vals = np.array([m[key] for m in matches if np.isfinite(m[key])])
        return float(np.sqrt(np.mean(vals**2))) if vals.size else float("nan")

    return {
        "matches": matches,
        "numDetections": int(valid.sum()),
        "numMatched": len(matches),
        "numTargets": len(truth),
        "rngRMSE": rmse("rngErr"),
        "velRMSE": rmse("velErr"),
        "aziRMSE": rmse("aziErr"),
        "eleRMSE": rmse("eleErr"),
    }


def _marcum_q1(a: np.ndarray, b: np.ndarray, terms: int = 200) -> np.ndarray:
    """Marcum Q_1(a, b) by series in the noncentral chi-square CDF form."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    # Q1(a,b) = exp(-(a^2+b^2)/2) sum_k (a b / 1)^k ... use robust summation:
    # Q1(a,b) = sum_{k=0..inf} exp(-a^2/2) (a^2/2)^k / k! * Q_gamma(k+1, b^2/2)
    # where Q_gamma is the upper regularized gamma = sum_{j<=k} exp(-x) x^j/j!.
    x = b**2 / 2.0
    lam = a**2 / 2.0
    # iterate Poisson weights and survival of Poisson(x)
    q = np.zeros(np.broadcast(a, b).shape)
    pois_lam = np.exp(-lam)  # P(K=0)
    surv = np.exp(-x)  # sum_{j<=0} e^-x x^j/j!
    term_x = np.exp(-x)
    for k in range(terms):
        q = q + pois_lam * surv
        pois_lam = pois_lam * lam / (k + 1)
        term_x = term_x * x / (k + 1)
        surv = surv + term_x
    return np.clip(q, 0.0, 1.0)


def roc_pd(snr_db: np.ndarray, pfa: float) -> np.ndarray:
    """Pd vs SNR for a nonfluctuating target, coherent detection (rocpfa analogue):
    Pd = Q_1(sqrt(2 SNR), sqrt(-2 ln Pfa))."""
    snr = 10.0 ** (np.asarray(snr_db, dtype=np.float64) / 10.0)
    return _marcum_q1(np.sqrt(2.0 * snr), np.sqrt(-2.0 * np.log(pfa)))
