"""Sensing stack: radar params, echo channel, RDM, CFAR, DoA, metrics.

Top-level `fft_2d_estimate` mirrors +sensing/+estimation/fft2D.m's role: RDM ->
per-antenna CA-CFAR -> union -> range/velocity estimates -> MUSIC DoA.
"""

from __future__ import annotations

import torch

from isac_tpu_torch.ops.sensing.cfar import (
    CFARConfig,
    cfar_detect_map,
    cfar_extract_detections,
    detections_to_estimates,
    make_cfar_config,
)
from isac_tpu_torch.ops.sensing.doa import (
    beamscan_doa,
    music_2d,
    music_doa,
    mvdr_doa,
    spatial_covariance,
)
from isac_tpu_torch.ops.sensing.echo import apply_radar_channel, mono_static_sensing
from isac_tpu_torch.ops.sensing.metrics import get_rmse, roc_pd
from isac_tpu_torch.ops.sensing.radar_params import (
    RadarDerived,
    derive_radar_params,
    steering_vector,
)
from isac_tpu_torch.ops.sensing.rdm import range_doppler_map, rdm_power
from isac_tpu_torch.utils import tracing

__all__ = [
    "CFARConfig", "cfar_detect_map", "cfar_extract_detections", "detections_to_estimates",
    "make_cfar_config", "beamscan_doa", "music_2d", "music_doa", "mvdr_doa",
    "spatial_covariance", "apply_radar_channel", "mono_static_sensing", "get_rmse",
    "roc_pd", "RadarDerived", "derive_radar_params", "steering_vector",
    "range_doppler_map", "rdm_power", "fft_2d_estimate", "music_2d_estimate",
]


def _doa(rx_grid, params, doa_method, max_targets, num_detections=None):
    """Spatial covariance -> the chosen DoA estimator's dict."""
    if doa_method not in ("music", "beamscan", "mvdr"):
        raise ValueError(f"unknown doa method '{doa_method}'")
    with tracing.span("sensing.doa"):
        ra = spatial_covariance(rx_grid)
        if doa_method == "music":
            return music_doa(ra, params, max_targets=max_targets,
                             num_detections=num_detections)
        if doa_method == "beamscan":
            return beamscan_doa(ra, params, max_targets=max_targets)
        return mvdr_doa(ra, params, max_targets=max_targets)


def fft_2d_estimate(
    rx_grid: torch.Tensor,
    tx_grid: torch.Tensor,
    params: RadarDerived,
    cfg: CFARConfig | None = None,
    doa_method: str = "music",
    max_targets: int = 4,
    rdm: torch.Tensor | None = None,
):
    """Full 2D-FFT estimation chain (fft2D.m:30-116).

    `rdm` injects a precomputed range-Doppler map in place of the serial map.

    rx_grid/tx_grid: [n_ants, n_sym, n_sc]. Returns dict with rngEst/velEst/
    aziEst/eleEst [K] (NaN-masked), valid [K], plus the RDM for inspection.

    Per-antenna CFAR maps are OR-combined (fft2D.m:59-99 loops antennas and
    unions estimates); peak extraction runs on the max-over-antennas power.
    """
    if cfg is None:
        cfg = make_cfar_config(params)
    if rdm is None:
        with tracing.span("sensing.rdm"):
            rdm = range_doppler_map(rx_grid, tx_grid, params.n_ifft, params.n_fft)
    with tracing.span("sensing.cfar"):
        power = torch.abs(rdm) ** 2  # [n_ants, R, C]
        det_maps = cfar_detect_map(power, cfg)  # batched over antennas
        det_union = torch.any(det_maps, dim=0)
        pmax = torch.amax(power, dim=0)
        dets = cfar_extract_detections(pmax, det_union, cfg)
        est = detections_to_estimates(dets, params)
        num_det = torch.sum(dets["valid"].to(torch.int32))
    doa = _doa(rx_grid, params, doa_method, max_targets, num_detections=num_det)
    est["aziEst"] = doa["azEst"]
    est["eleEst"] = doa["elEst"]
    est["doa_valid"] = doa["valid"]
    est["rdm"] = rdm
    return est


def music_2d_estimate(
    rx_grid: torch.Tensor,
    tx_grid: torch.Tensor,
    params: RadarDerived,
    doa_method: str = "music",
    max_targets: int = 4,
):
    """Full range/velocity/DoA MUSIC chain (music2D.m:56-123) — the
    est_algorithm='MUSIC' alternative.

    Element-wise channel H = rx .* conj(tx) of antenna 0 (music2D.m:66-69);
    range/velocity spectra from its subcarrier/symbol correlation matrices;
    DoA from the spatial covariance exactly as in fft_2d_estimate, with the
    signal count from the eigenvalue gaps."""
    with tracing.span("sensing.music_2d"):
        ch = rx_grid[0] * torch.conj(tx_grid[0])  # [n_sym, n_sc], first antenna
        est = music_2d(ch, params, max_targets=max_targets)
    doa = _doa(rx_grid, params, doa_method, max_targets)
    est["aziEst"] = doa["azEst"]
    est["eleEst"] = doa["elEst"]
    est["doa_valid"] = doa["valid"]
    return est
