"""Layered normalised min-sum decoding of a lifted QC-LDPC code, in plain
float32 PyTorch.

The base graphs are a frozen copy (``base_graphs.json``): the TS 38.212
protograph of BG1 (46 x 68, 316 entries) and BG2 (42 x 52, 197 entries) with
the eight shift values of each entry, one per lifting set, that the
repository decodes with. Lifting size z takes set i of a * 2^j with a the
i-th of (2, 3, 5, 7, 9, 11, 13, 15) and the shift V mod z; edge e of row r
reads lane (i + shift) mod z of column c.

Each row of each iteration, in row order: t = L - R_old (nothing subtracted
in the first iteration), R_new = (norm * prod sign t) * sign t_e * min over the
row's other edges of |t|, L = t + R_new, with -0 counted as positive. Every
step is one IEEE float32 operation, so the result does not depend on the
device or on the order of a row's edges.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

_LIFT_A = (2, 3, 5, 7, 9, 11, 13, 15)
SHAPES = {1: (46, 68), 2: (42, 52)}


@lru_cache(maxsize=None)
def _tables() -> dict:
    return json.loads((Path(__file__).parent / "base_graphs.json").read_text())


def lifting_set(z: int) -> int:
    a = z
    while a % 2 == 0 and a not in _LIFT_A:
        a //= 2
    return _LIFT_A.index(a)


@lru_cache(maxsize=64)
def row_edges(bg: int, z: int) -> tuple:
    """Per row: (columns [d], shifts [d]) of its edges."""
    ils = lifting_set(z)
    rows: dict = {}
    for r, c, s in _tables()[f"bg{bg}"]:
        rows.setdefault(r, []).append((c, s[ils] % z))
    return tuple((np.asarray([c for c, _ in rows[r]]), np.asarray([s for _, s in rows[r]]))
                 for r in range(SHAPES[bg][0]))


def posterior(llr: torch.Tensor, bg: int, z: int, n_iter: int, norm: float,
              dtype=torch.float32) -> torch.Tensor:
    """Posterior [B, n_cols, z] after n_iter layered sweeps of llr
    [..., n_cols * z] (positive = bit 0), computed in `dtype`."""
    n_cols = SHAPES[bg][1]
    lv = llr.reshape(-1, n_cols * z).to(dtype).clone()
    dev = lv.device
    lane = torch.arange(z, device=dev)
    plan = []
    for cols, shifts in row_edges(bg, z):
        c = torch.as_tensor(cols, device=dev)[:, None]
        s = torch.as_tensor(shifts, device=dev)[:, None]
        plan.append((c * z + (lane[None, :] + s) % z).reshape(-1))
    msgs: list = [None] * len(plan)
    b = lv.shape[0]
    for _ in range(n_iter):
        for r, idx in enumerate(plan):
            t = lv[:, idx].view(b, -1, z)
            if msgs[r] is not None:
                t = t - msgs[r]
            neg = ~(t >= 0)
            mag = torch.abs(t)
            m1, arg = torch.min(mag, dim=1, keepdim=True)
            others = mag.scatter(1, arg, float("inf"))
            m2 = torch.amin(others, dim=1, keepdim=True)
            sprod = 1.0 - 2.0 * (neg.sum(dim=1, keepdim=True) % 2).to(dtype)
            sgn = torch.where(neg, -1.0, 1.0).to(dtype)
            pick = torch.where(torch.arange(t.shape[1], device=dev)[None, :, None] == arg, m2, m1)
            msg = ((norm * sprod) * sgn) * pick
            lv[:, idx] = (t + msg).reshape(b, -1)
            msgs[r] = msg
    return lv.view(b, n_cols, z)
