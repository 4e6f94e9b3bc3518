"""Geometry helpers: spherical conversions, Poisson drops, hex layout support.

Mirrors MATLAB ``cart2sph`` convention used by the reference
(+sensing/radarParams.m:13): azimuth measured in the x-y plane from +x,
elevation from the x-y plane toward +z.
"""

from __future__ import annotations

import numpy as np


def cart2sph(x, y, z):
    """MATLAB-convention cartesian -> (azimuth, elevation, range), radians."""
    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    hypot_xy = np.hypot(x, y)
    r = np.hypot(hypot_xy, z)
    az = np.arctan2(y, x)
    el = np.arctan2(z, hypot_xy)
    return az, el, r


def sph2cart(az, el, r):
    az, el, r = np.asarray(az), np.asarray(el), np.asarray(r)
    return r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)


def hexagon_vertices(center: np.ndarray, radius: float) -> np.ndarray:
    """Flat-top hexagon vertices around center [x, y]. Shape [6, 2]."""
    ang = np.arange(6) * np.pi / 3.0
    return np.stack([center[0] + radius * np.cos(ang), center[1] + radius * np.sin(ang)], axis=-1)


def point_in_hexagon(points: np.ndarray, center: np.ndarray, radius: float) -> np.ndarray:
    """Vectorized point-in-convex-polygon for a hexagon. points: [N, 2] -> bool [N]."""
    verts = hexagon_vertices(center, radius)
    edges = np.roll(verts, -1, axis=0) - verts  # [6, 2]
    rel = points[:, None, :] - verts[None, :, :]  # [N, 6, 2]
    cross = edges[None, :, 0] * rel[:, :, 1] - edges[None, :, 1] * rel[:, :, 0]
    return np.all(cross >= 0, axis=1) | np.all(cross <= 0, axis=1)


def poisson_points_2d(
    rng: np.random.Generator,
    center: np.ndarray,
    radius: float,
    density_or_count,
    height: float = 0.0,
    exact_count: bool = True,
    wedge: tuple | None = None,
) -> np.ndarray:
    """Poisson point drop inside a hexagon around `center`, rejection-sampled.

    Mirrors +parameters/+user/poisson2D.m generatePoissonPoints: a Poisson (or
    fixed) count of points uniformly placed inside the hexagonal cell.
    `wedge` = (boresight_deg, width_deg) keeps only the points whose azimuth
    from `center` lies within width / 2 of the boresight (a sector's drop);
    None keeps the whole hexagon, with the same draws as before.
    Returns [N, 3] positions with the given height.
    """
    if exact_count:
        n = int(density_or_count)
    else:
        area = 3.0 * np.sqrt(3.0) / 2.0 * radius**2
        n = int(rng.poisson(density_or_count * area))
    pts = np.zeros((n, 2))
    got = 0
    while got < n:
        cand = rng.uniform(-radius, radius, size=(max(8, 2 * (n - got)), 2)) + center[None, :]
        ok = point_in_hexagon(cand, center, radius)
        if wedge is not None:
            rel = cand - center[None, :]
            off = (np.degrees(np.arctan2(rel[:, 1], rel[:, 0])) - wedge[0] + 180.0) % 360.0 - 180.0
            ok &= np.abs(off) <= wedge[1] / 2.0
        take = cand[ok][: n - got]
        pts[got : got + take.shape[0]] = take
        got += take.shape[0]
    return np.concatenate([pts, np.full((n, 1), height)], axis=1)


def db2pow(db):
    return 10.0 ** (np.asarray(db, dtype=np.float64) / 10.0)


def pow2db(p):
    return 10.0 * np.log10(np.asarray(p, dtype=np.float64))


def db2mag(db):
    return 10.0 ** (np.asarray(db, dtype=np.float64) / 20.0)


def mag2db(m):
    return 20.0 * np.log10(np.asarray(m, dtype=np.float64))


SPEED_OF_LIGHT = 299792458.0
BOLTZMANN = 1.380649e-23
