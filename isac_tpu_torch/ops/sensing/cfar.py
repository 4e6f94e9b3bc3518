"""2D CA-CFAR detection — vectorized sliding windows, fixed-capacity outputs.

Counterpart of +sensing/+detection/cfar2D.m:1-39 +
phased.CFARDetector2D('CA', Pfa-auto threshold, guard [2 2], training [1 1]).

Design: the per-CUT training-cell mean is two box sums (outer minus inner
window), each one pooling call over the whole map — O(1) per cell, fully
parallel — instead of the System-object per-CUT loop. Detections are returned
as a boolean map plus a top-K extraction (fixed capacity, mask-padded), which
keeps every shape static and needs no host round trip.

The box sums add their 49 / 25 cells in the pooling kernel's order, which is
not the JAX package's `reduce_window` order: the noise estimate differs by
float32 rounding, so a cell whose power sits within ~1e-6 (relative) of its
threshold may fall on the other side.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from isac_tpu_torch.ops.sensing.radar_params import RadarDerived


def ca_threshold_factor(pfa: float, num_training: int) -> float:
    """CA-CFAR scale: alpha = N (Pfa^(-1/N) - 1) (exponential noise)."""
    n = float(num_training)
    return n * (pfa ** (-1.0 / n) - 1.0)


@dataclass(frozen=True)
class CFARConfig:
    """Detector + CUT zone (cfar2D.m output struct)."""

    guard: tuple = (2, 2)
    training: tuple = (1, 1)
    pfa: float = 1e-9
    zone_rows: tuple = (0, 0)  # inclusive range-bin window (CUT zone)
    zone_cols: tuple = (0, 0)  # inclusive Doppler-bin window
    max_detections: int = 16

    @property
    def num_training(self) -> int:
        gr, gc = self.guard
        tr, tc = self.training
        outer = (2 * (gr + tr) + 1) * (2 * (gc + tc) + 1)
        inner = (2 * gr + 1) * (2 * gc + 1)
        return outer - inner

    @property
    def threshold_factor(self) -> float:
        return ca_threshold_factor(self.pfa, self.num_training)


def make_cfar_config(params: RadarDerived, max_detections: int = 16) -> CFARConfig:
    """CUT zone from the configured range/velocity detection area (cfar2D.m:13-24)."""
    rng_grid = np.arange(params.n_ifft) * params.r_res
    dop_grid = (np.arange(params.n_fft) - params.n_fft / 2) * params.v_res
    (rmin, rmax), (vmin, vmax) = params.cfar_zone
    r0 = int(np.argmin(np.abs(rng_grid - rmin)))
    r1 = int(np.argmin(np.abs(rng_grid - rmax)))
    c0 = int(np.argmin(np.abs(dop_grid - vmin)))
    c1 = int(np.argmin(np.abs(dop_grid - vmax)))
    return CFARConfig(
        pfa=params.pfa,
        zone_rows=(r0, r1),
        zone_cols=(c0, c1),
        max_detections=max_detections,
    )


def top_k_lowest_index_first(metric: torch.Tensor, k: int):
    """(values [k], indices [k]) of the k largest entries of a 1D float32
    tensor, descending, and among equal values the LOWEST index first — the
    order `jax.lax.top_k` gives and `torch.topk` does not promise. The float is
    mapped to an integer of the same order and joined with the reversed index
    into one int64 key, so that no two keys are equal."""
    n = metric.shape[0]
    bits = metric.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev_idx = (n - 1) - torch.arange(n, dtype=torch.int64, device=metric.device)
    key = (ordered << 32) | rev_idx
    idx = (n - 1) - (torch.topk(key, k).values & 0xFFFFFFFF)
    return metric[idx], idx


def _box_sum(x: torch.Tensor, half_r: int, half_c: int) -> torch.Tensor:
    """Sum over a (2*half_r+1) x (2*half_c+1) window centered per cell (zero pad).
    x is [R, C] or [batch, R, C]."""
    x3 = x if x.ndim == 3 else x[None]
    s = F.avg_pool2d(
        x3[:, None],
        kernel_size=(2 * half_r + 1, 2 * half_c + 1),
        stride=1,
        padding=(half_r, half_c),
        divisor_override=1,
    )[:, 0]
    return s if x.ndim == 3 else s[0]


def cfar_detect_map(power: torch.Tensor, cfg: CFARConfig) -> torch.Tensor:
    """power [..., R, C] -> bool detection map [..., R, C] restricted to the CUT zone."""
    gr, gc = cfg.guard
    tr, tc = cfg.training
    outer = _box_sum(power, gr + tr, gc + tc)
    inner = _box_sum(power, gr, gc)
    noise = (outer - inner) / cfg.num_training
    det = power > cfg.threshold_factor * noise
    r, c = power.shape[-2:]
    rows = torch.arange(r, device=power.device)[:, None]
    cols = torch.arange(c, device=power.device)[None, :]
    zone = (
        (rows >= cfg.zone_rows[0])
        & (rows <= cfg.zone_rows[1])
        & (cols >= cfg.zone_cols[0])
        & (cols <= cfg.zone_cols[1])
    )
    return det & zone


def cfar_extract_detections(power: torch.Tensor, det_map: torch.Tensor, cfg: CFARConfig):
    """Top-K detections by peak power with local-max suppression.

    power/det_map [R, C] -> dict of row [K], col [K], peak [K], valid [K] (bool).
    Local-max suppression keeps one detection per peak (the MATLAB reference
    instead reports every CFAR-crossing cell and dedups estimates by value).
    Entries that are not `valid` carry arbitrary row/col.
    """
    # max_pool2d pads with -inf, like the reference's window maximum
    local_max = power >= F.max_pool2d(power[None, None], 3, stride=1, padding=1)[0, 0]
    neg_inf = torch.full((), -torch.inf, dtype=power.dtype, device=power.device)
    metric = torch.where(det_map & local_max, power, neg_inf).reshape(-1)
    peak, idx = top_k_lowest_index_first(metric, cfg.max_detections)
    valid = torch.isfinite(peak)
    c = power.shape[-1]
    return {
        "row": idx // c,
        "col": idx % c,
        "peak": torch.where(valid, peak, torch.zeros_like(peak)),
        "valid": valid,
    }


def detections_to_estimates(dets: dict, params: RadarDerived) -> dict:
    """Detection bins -> range/velocity (fft2D.m:77-82): rng = row * rRes,
    vel = (col - nFFT/2) * vRes."""
    rng = dets["row"].to(torch.float32) * params.r_res
    vel = (dets["col"].to(torch.float32) - params.n_fft / 2) * params.v_res
    nan = torch.full_like(rng, torch.nan)
    return {
        "rngEst": torch.where(dets["valid"], rng, nan),
        "velEst": torch.where(dets["valid"], vel, nan),
        "peak": dets["peak"],
        "valid": dets["valid"],
    }
