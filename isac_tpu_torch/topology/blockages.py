"""3D blockage geometry: walls, buildings, city, and vectorized LoS checks
(counterpart of isac_tpu/topology/blockages.py: the same float64 numpy
expressions in the same order, so every answer is the reference's).

Re-design of the reference's +networkTopology/+blockages/ classes
(wallBlockage.m:26-214, building.m:37-183, city.m:1-60, openStreetMapCity.m:67-94).
The reference tests one UE-antenna segment against one wall at a time via
plane projection + winding-number point-in-polygon; here every wall of every
building is flattened into stacked numpy arrays and all N links are tested
against all W walls in one broadcasted pass (host-side setup work — LoS
booleans are scenario constants, not per-slot device work).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Building:
    """Extruded-polygon building (building.m:37-99).

    floor_plan: [n_corners, 2] (x, y) vertices of the footprint (open polygon —
    the closing edge is implicit). height: extrusion in meters. loss_db: wall
    penetration loss (city parameter wallLossdB)."""

    floor_plan: np.ndarray
    height: float
    name: str = ""
    loss_db: float = 20.0

    @property
    def num_walls(self) -> int:
        return self.floor_plan.shape[0]

    def wall_segments(self) -> np.ndarray:
        """[n_walls, 4]: x1, y1, x2, y2 per vertical wall (edges of the
        footprint incl. the closing edge; building.m:82-98 builds one
        wallBlockage per edge)."""
        fp = self.floor_plan
        nxt = np.roll(fp, -1, axis=0)
        return np.concatenate([fp, nxt], axis=1)

    def contains_xy(self, pts: np.ndarray) -> np.ndarray:
        """Point-in-footprint for [N, 2] points (building.m checkIsInside,
        :139-183 — winding number; here an even-odd crossing test)."""
        return _points_in_polygon(pts, self.floor_plan)


@dataclass(frozen=True)
class StreetSystem:
    """Street graph (streetSystem.m:1-50): node locations + connectivity.
    Plot/area bookkeeping only — no RF effect (SURVEY §2.3)."""

    node_locations: np.ndarray  # [n_nodes, 2]
    connection_matrix: np.ndarray  # [n_nodes, n_nodes] bool
    street_width: float = 10.0
    labels: tuple = ()


@dataclass
class City:
    """Collection of buildings + streets with vectorized LoS checks
    (city.m:1-60, openStreetMapCity.m:67-94)."""

    buildings: list = field(default_factory=list)
    streets: StreetSystem | None = None
    origin_latlon: tuple = (0.0, 0.0)

    # stacked wall arrays, built lazily
    _walls: np.ndarray | None = None  # [W, 5]: x1 y1 x2 y2 h
    _wall_loss: np.ndarray | None = None  # [W]

    def _stack_walls(self):
        if self._walls is not None:
            return
        segs, loss = [], []
        for b in self.buildings:
            s = b.wall_segments()
            segs.append(np.concatenate([s, np.full((s.shape[0], 1), b.height)], axis=1))
            loss.append(np.full(s.shape[0], b.loss_db))
        if segs:
            self._walls = np.concatenate(segs, axis=0)
            self._wall_loss = np.concatenate(loss)
        else:
            self._walls = np.zeros((0, 5))
            self._wall_loss = np.zeros((0,))

    def blockage_count(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Number of wall/ceiling crossings per segment.

        a, b: [N, 3] segment endpoints. Returns int [N]. LoS == (count == 0)
        (openStreetMapCity.m:67-94: OR over buildings' checkBlockage)."""
        a = np.atleast_2d(np.asarray(a, np.float64))
        b = np.atleast_2d(np.asarray(b, np.float64))
        self._stack_walls()
        count = _segments_cross_walls(a, b, self._walls).sum(axis=1)
        for bl in self.buildings:
            count += _segment_crosses_ceiling(a, b, bl.floor_plan, bl.height)
        return count

    def check_los(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """bool [N]: True = line of sight (no blockage)."""
        return self.blockage_count(a, b) == 0

    def penetration_loss_db(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Sum of per-wall penetration losses along each segment (wallLossdB
        semantics from +parameters/+city/parameters.m)."""
        a = np.atleast_2d(np.asarray(a, np.float64))
        b = np.atleast_2d(np.asarray(b, np.float64))
        self._stack_walls()
        hit = _segments_cross_walls(a, b, self._walls)  # [N, W]
        loss = hit @ self._wall_loss
        for bl in self.buildings:
            loss += _segment_crosses_ceiling(a, b, bl.floor_plan, bl.height) * bl.loss_db
        return loss

    def to_json_dict(self) -> dict:
        """Serialize in the reference's OSM_city.json schema
        (openStreetMapCity.m:51-64 save/load cache)."""
        return {
            "buildings": [
                {
                    "name": bl.name,
                    "floorPlan": [bl.floor_plan[:, 0].tolist(), bl.floor_plan[:, 1].tolist()],
                    "height": float(bl.height),
                    "loss": [] if bl.loss_db is None else [float(bl.loss_db)],
                }
                for bl in self.buildings
            ],
            "streetSystem": {
                "nodeLocations": []
                if self.streets is None
                else [
                    self.streets.node_locations[:, 0].tolist(),
                    self.streets.node_locations[:, 1].tolist(),
                ],
                "connectionMatrix": []
                if self.streets is None
                else self.streets.connection_matrix.astype(float).tolist(),
                "labels": list(self.streets.labels) if self.streets else [],
                "streetWidth": self.streets.street_width if self.streets else 10.0,
            },
        }


# --------------------------------------------------------------------- geometry


def _segments_cross_walls(a: np.ndarray, b: np.ndarray, walls: np.ndarray) -> np.ndarray:
    """Vectorized segment-vs-vertical-wall intersection.

    a, b: [N, 3]; walls: [W, 5] (x1 y1 x2 y2 h). Returns bool [N, W].

    A vertical wall is the quad {(x1,y1,0),(x2,y2,0),(x2,y2,h),(x1,y1,h)}.
    Intersection reduces to: the 2D segment (a_xy -> b_xy) crosses the 2D wall
    segment, and the interpolated z at the crossing lies in [0, h]. This is
    exactly the reference's plane-projection + in-polygon test
    (wallBlockage.m:114-119,183-214) specialized to rectangular vertical walls.
    """
    if walls.shape[0] == 0:
        return np.zeros((a.shape[0], 0), dtype=bool)
    p = a[:, None, :2]  # [N, 1, 2]
    r = (b - a)[:, None, :2]  # [N, 1, 2]
    q = walls[None, :, 0:2]  # [1, W, 2]
    s = walls[None, :, 2:4] - q  # [1, W, 2]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]  # [N, W]
    qp = q - p
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t_num / rxs
        u = u_num / rxs
    par = np.abs(rxs) <= 1e-12
    t = np.where(par, -1.0, t)
    u = np.where(par, -1.0, u)
    ok = ~par & (t > 0.0) & (t < 1.0) & (u >= 0.0) & (u <= 1.0)
    z = a[:, None, 2] + np.where(ok, t, 0.0) * (b - a)[:, None, 2]
    return ok & (z >= 0.0) & (z <= walls[None, :, 4])


def _segment_crosses_ceiling(
    a: np.ndarray, b: np.ndarray, floor_plan: np.ndarray, height: float
) -> np.ndarray:
    """Segment vs horizontal ceiling polygon at z = height (building.m:82-98
    ceiling wallBlockage). Returns bool [N]."""
    dz = b[:, 2] - a[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(np.abs(dz) > 1e-12, (height - a[:, 2]) / dz, -1.0)
    ok = (t > 0.0) & (t < 1.0)
    if not ok.any():
        return np.zeros(a.shape[0], dtype=bool)
    pt = a[:, :2] + np.where(ok, t, 0.0)[:, None] * (b[:, :2] - a[:, :2])
    inside = _points_in_polygon(pt, floor_plan)
    return ok & inside


def _points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd crossing-number point-in-polygon, vectorized over [N, 2] points
    (replaces the reference's winding-number sum, wallBlockage.m:169-214)."""
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]  # [N, 1]
    px, py = poly[:, 0][None, :], poly[:, 1][None, :]  # [1, V]
    qx, qy = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    cond = (py > y) != (qy > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_cross = px + (y - py) * (qx - px) / (qy - py)
    crossings = (cond & (x < x_cross)).sum(axis=1)
    return (crossings % 2) == 1
