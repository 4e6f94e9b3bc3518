"""Hexagonal multi-cell layout with wraparound distances (counterpart of
isac_tpu/topology/wraparound.py; host numpy, the same draws).

Re-design of +networkTopology/+wraparound/generateWrapAround.m:1-181:
hex-grid gNB placement inside an ROI, per-cell Poisson UE drops inside each
hexagon, 3-sector azimuth split, and wraparound-corrected distances/azimuths
(the reference computes each UE's distance to the closest mirror image of each
gNB across the 7 wraparound replicas of the layout).
"""

from __future__ import annotations

import numpy as np

from isac_tpu_torch.utils.geometry import poisson_points_2d


def hex_cell_centers(num_cells: int, inter_site_distance: float = 500.0) -> np.ndarray:
    """First `num_cells` hex-grid centers spiraling out from the origin.

    Ring k holds 6k sites; centers use the standard pointy-top hex tiling with
    site pitch = inter_site_distance (getgNBPositions,
    generateWrapAround.m:94-166)."""
    isd = inter_site_distance
    centers = [(0.0, 0.0)]
    k = 1
    # axial-coordinate ring walk
    dirs = [(1, 0), (0, 1), (-1, 1), (-1, 0), (0, -1), (1, -1)]
    while len(centers) < num_cells:
        q, r = k, 0
        for d in range(6):
            for _ in range(k):
                q += dirs[(d + 2) % 6][0]
                r += dirs[(d + 2) % 6][1]
                x = isd * (q + r / 2.0)
                y = isd * (np.sqrt(3.0) / 2.0) * r
                centers.append((x, y))
        k += 1
    return np.asarray(centers[:num_cells], dtype=np.float64)


def wraparound_offsets(num_rings: int, inter_site_distance: float) -> np.ndarray:
    """The 7 translation vectors (incl. zero) that tile the hex cluster for
    wraparound distance computation (generateWrapAround.m wrap logic)."""
    isd = inter_site_distance
    n = num_rings
    # cluster translation basis for a (3n^2+3n+1)-cell hex cluster
    a1 = isd * np.array([2 * n + 0.5, np.sqrt(3) / 2.0])
    a2 = isd * np.array([-(n + 0.5), np.sqrt(3) * (n + 0.5)])
    offs = [np.zeros(2)]
    for i, j in [(1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, -1)]:
        offs.append(i * a1 + j * a2)
    return np.asarray(offs)


def wraparound_distance(
    ue_xy: np.ndarray, gnb_xy: np.ndarray, num_rings: int, inter_site_distance: float
):
    """Min distance and azimuth from each UE to each gNB over wraparound
    replicas. ue_xy [N, 2], gnb_xy [M, 2] -> (dist [N, M], azimuth_deg [N, M])."""
    offs = wraparound_offsets(num_rings, inter_site_distance)  # [7, 2]
    d = ue_xy[:, None, None, :] - (gnb_xy[None, :, None, :] + offs[None, None, :, :])
    dist = np.linalg.norm(d, axis=-1)  # [N, M, 7]
    best = np.argmin(dist, axis=-1)
    take = np.take_along_axis(d, best[..., None, None], axis=2)[:, :, 0, :]
    az = np.degrees(np.arctan2(take[..., 1], take[..., 0]))
    return np.min(dist, axis=-1), az


def generate_wraparound(
    num_cells: int,
    inter_site_distance: float = 500.0,
    ues_per_cell: int = 5,
    ue_height: float = 1.5,
    num_sectors: int = 3,
    seed: int = 0,
):
    """Full layout (generateWrapAround.m:1-181): hex gNB positions, per-cell
    Poisson UE drops inside each hexagon, sector azimuths.

    Returns dict with gnb_positions [M, 2], ue_positions [M, n_ue, 3],
    sector_azimuths_deg [num_sectors], distances [M, n_ue], azimuths [M, n_ue].
    """
    rng = np.random.default_rng(seed)
    centers = hex_cell_centers(num_cells, inter_site_distance)
    radius = inter_site_distance / np.sqrt(3.0)
    ue_pos = np.stack(
        [
            poisson_points_2d(rng, centers[m], radius, ues_per_cell, ue_height)
            for m in range(num_cells)
        ]
    )
    d = ue_pos[..., :2] - centers[:, None, :]
    dist = np.linalg.norm(d, axis=-1)
    az = np.degrees(np.arctan2(d[..., 1], d[..., 0]))
    sector_az = np.arange(num_sectors) * (360.0 / num_sectors) + 30.0
    return {
        "gnb_positions": centers,
        "ue_positions": ue_pos,
        "sector_azimuths_deg": sector_az,
        "distances": dist,
        "azimuths_deg": az,
    }
