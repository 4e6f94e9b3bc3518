"""NZP CSI-RS generation and estimation per TS 38.211 §7.4.1.5
(nrCSIRS/nrCSIRSIndices analogue; counterpart of isac_tpu/ops/csirs.py).

The reference uses row 5 (4 ports, density 1, CDM-FD2) with period [5 2]
(+communication/setupCSIRS.m:1-33). Supported rows:
- row 1: 1 port, density 3 (k0, k0+4, k0+8), no CDM
- row 4: 4 ports, density 1, two FD-CDM2 groups at k0, k0+2
- row 5: 4 ports, density 1, FD-CDM2 at (k0, k0+1) over two symbols (l0, l0+1)

Sequence r(m) is Gold-QPSK with c_init = (2^10 (14 ns + l + 1)(2 nID + 1) + nID)
mod 2^31 (§7.4.1.5.2).

The fill functions are host numpy; the estimators are tensor gathers whose
index and reference planes are uploaded once per (key, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.utils.sequences import gold_qpsk


def csirs_cinit(slot: int, symbol: int, n_id: int) -> int:
    return ((1 << 10) * (14 * slot + symbol + 1) * (2 * n_id + 1) + n_id) % (1 << 31)


def csirs_sequence(slot: int, symbol: int, n_id: int, length: int, offset: int = 0) -> np.ndarray:
    return gold_qpsk(csirs_cinit(slot, symbol, n_id), length, offset_pairs=offset)


def csirs_fill_grid(
    grid: np.ndarray,  # [n_ports, n_sym, n_sc]
    slot: int,
    n_id: int,
    n_prb: int,
    row: int = 5,
    k0: int = 0,
    l0: int = 5,
    prb_start: int = 0,
):
    """Write CSI-RS into the port grid. Returns (grid, mask [n_sym, n_sc]).

    Port p signals are CDM-orthogonal: FD-OCC over paired subcarriers,
    TD-OCC over paired symbols (row 5).
    """
    n_ports = grid.shape[0]
    mask = np.zeros(grid.shape[-2:], bool)
    prbs = np.arange(prb_start, prb_start + n_prb)
    if row == 1:
        assert n_ports >= 1
        ks = (prbs[:, None] * 12 + k0 + np.array([0, 4, 8])[None, :]).reshape(-1)
        r = csirs_sequence(slot, l0, n_id, len(ks))
        grid[0, l0, ks] = r
        mask[l0, ks] = True
        return grid, mask
    if row == 4:
        # 4 ports: two FD-CDM2 groups at k0 and k0+2, same symbol
        base = prbs * 12 + k0
        r = csirs_sequence(slot, l0, n_id, 2 * len(base))
        for p in range(min(4, n_ports)):
            grp, occ = divmod(p, 2)
            ks = base + 2 * grp
            w = np.array([1.0, 1.0]) if occ == 0 else np.array([1.0, -1.0])
            for i, dk in enumerate((0, 1)):
                grid[p, l0, ks + dk] = r.reshape(-1, 2)[:, i] * w[i]
                mask[l0, ks + dk] = True
        return grid, mask
    if row == 5:
        # 4 ports: FD-CDM2 x TD-CDM... row 5 uses (k0,k0+1) x (l0,l0+1), cdm=FD-CDM2
        base = prbs * 12 + k0
        for li, l in enumerate((l0, l0 + 1)):
            r = csirs_sequence(slot, l, n_id, 2 * len(base))
            for p in range(min(4, n_ports)):
                grp, occ = divmod(p, 2)  # grp selects symbol-pair half
                if grp != li:
                    continue
                w = np.array([1.0, 1.0]) if occ == 0 else np.array([1.0, -1.0])
                for i, dk in enumerate((0, 1)):
                    grid[p, l, base + dk] = r.reshape(-1, 2)[:, i] * w[i]
            mask[l, base] = True
            mask[l, base + 1] = True
        return grid, mask
    raise NotImplementedError(f"CSI-RS row {row} not supported")


def csirs_fdm_layout(n_ports: int, l0: int = 5) -> tuple:
    """FDM CSI-RS resource for up to 24 ports: port p occupies one RE per PRB
    at (symbol l0 + p//12, subcarrier-in-PRB p%12). Density 1, no CDM — the
    simplest spec-shaped mapping that scales past row 5's 4 ports (the
    reference measures only a 4-port channel through its ULA-16, setupCSIRS.m;
    here the CSI sees the full array). Returns ((sym, sc_off), ...) per port."""
    if n_ports > 24:
        raise ValueError(f"FDM CSI-RS supports <= 24 ports, got {n_ports}")
    return tuple((l0 + p // 12, p % 12) for p in range(n_ports))


def csirs_fill_fdm(
    slot: int, n_id: int, n_prb: int, n_ports: int, n_sc_grid: int, l0: int = 5
) -> np.ndarray:
    """Full-band FDM CSI-RS port grid [n_ports, 14, n_sc_grid] (host numpy)."""
    grid = np.zeros((n_ports, 14, n_sc_grid), np.complex64)
    prbs = np.arange(n_prb)
    for p, (l, off) in enumerate(csirs_fdm_layout(n_ports, l0)):
        r = csirs_sequence(slot, l, n_id, n_prb, offset=p * n_prb)
        grid[p, l, prbs * 12 + off] = r
    return grid


def _csirs_fdm_est_plan(slot: int, n_id: int, n_prb: int, n_ports: int, l0: int):
    layout = csirs_fdm_layout(n_ports, l0)
    sym = np.asarray([l for l, _ in layout], np.int32)  # [P]
    sc = np.stack(
        [np.arange(n_prb, dtype=np.int32) * 12 + off for _, off in layout]
    )  # [P, n_prb]
    refs_conj = np.conj(
        np.stack(
            [
                csirs_sequence(slot, l, n_id, n_prb, offset=p * n_prb)
                for p, (l, _) in enumerate(layout)
            ]
        ).astype(np.complex64)
    )
    return sym, sc, refs_conj


@lru_cache(maxsize=512)
def _cached_fdm_plan(slot: int, n_id: int, n_prb: int, n_ports: int, l0: int):
    return _csirs_fdm_est_plan(slot, n_id, n_prb, n_ports, l0)


@lru_cache(maxsize=512)
def _cached_fdm_plan_dev(slot: int, n_id: int, n_prb: int, n_ports: int,
                         l0: int, device: torch.device):
    """Device-resident plan: index and conjugated reference planes are
    uploaded once per (slot, n_id, ..., device) key, not on every call."""
    sym, sc, refs_conj = _cached_fdm_plan(slot, n_id, n_prb, n_ports, l0)
    return (torch.as_tensor(sym.astype(np.int64), device=device)[:, None],
            torch.as_tensor(sc.astype(np.int64), device=device),
            torch.as_tensor(refs_conj, device=device))


def csirs_estimate_fdm(
    rx_grid: torch.Tensor, slot: int, n_id: int, n_prb: int, n_ports: int,
    l0: int = 5, ue_index: int | None = None,
) -> torch.Tensor:
    """LS estimate at the FDM CSI-RS REs -> H [n_prb, n_rx, n_ports].

    One gather over every port. `ue_index` selects a leading batch entry
    (rx_grid is then [n_ues, n_rx, 14, K])."""
    sym, sc, refs_conj = _cached_fdm_plan_dev(slot, n_id, n_prb, n_ports, l0,
                                              rx_grid.device)
    rx = rx_grid if ue_index is None else rx_grid[int(ue_index)]
    y = rx[:, sym, sc]  # [n_rx, P, n_prb]
    return (y * refs_conj[None]).permute(2, 0, 1)  # [n_prb, n_rx, P]


def csirs_fdm_reserved(n_ports: int, l0: int = 5) -> tuple:
    """Reserved (symbol, sc_offset) pattern for PDSCH rate-matching around the
    FDM CSI-RS (gNBMAC.m:888-894 reserves CSI-RS REs in DL grants)."""
    return csirs_fdm_layout(n_ports, l0)


@lru_cache(maxsize=512)
def _row5_est_plan(slot: int, n_id: int, n_prb: int, k0: int, l0: int,
                   prb_start: int):
    base = (np.arange(prb_start, prb_start + n_prb) * 12 + k0).astype(np.int32)
    refs = np.stack([
        np.conj(csirs_sequence(slot, l0 + li, n_id, 2 * n_prb)
                .reshape(-1, 2).astype(np.complex64))
        for li in (0, 1)
    ])  # [2, n_prb, 2]
    return base, refs


@lru_cache(maxsize=512)
def _row5_est_plan_dev(slot: int, n_id: int, n_prb: int, k0: int, l0: int,
                       prb_start: int, device: torch.device):
    """Device-resident row-5 plan (one upload per key and device)."""
    base, refs = _row5_est_plan(slot, n_id, n_prb, k0, l0, prb_start)
    return (torch.as_tensor(base.astype(np.int64), device=device),
            torch.as_tensor(refs, device=device))


def _row5_est(rx: torch.Tensor, base: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """CDM-FD2 decode over the two CSI-RS symbols (5, 6) -> [n_prb, n_rx, 4]."""
    hs = []
    for li in range(2):
        y0 = rx[:, 5 + li, base]  # [n_rx, n_prb]
        y1 = rx[:, 5 + li, base + 1]
        ls0 = y0 * refs[li, :, 0]
        ls1 = y1 * refs[li, :, 1]
        hs += [(ls0 + ls1) / 2.0, (ls0 - ls1) / 2.0]  # ports 2li, 2li+1
    return torch.stack(hs, dim=-1).permute(1, 0, 2)


def csirs_estimate_ports(
    rx_grid: torch.Tensor,  # [n_rx, n_sym, n_sc] (or [n_ues, ...] with ue_index)
    slot: int,
    n_id: int,
    n_prb: int,
    row: int = 5,
    k0: int = 0,
    l0: int = 5,
    prb_start: int = 0,
    ue_index: int | None = None,
):
    """LS channel estimate at CSI-RS REs -> H [n_prb, n_rx, 4] + PRB ids.

    CDM decode mirrors csirs_fill_grid's row-5 mapping; `ue_index` selects a
    leading batch entry."""
    if row != 5:
        raise NotImplementedError("estimation implemented for row 5 (the reference default)")
    if l0 != 5:
        raise NotImplementedError("row-5 estimator assumes l0=5")
    base, refs = _row5_est_plan_dev(slot, n_id, n_prb, k0, l0, prb_start,
                                    rx_grid.device)
    prbs = np.arange(prb_start, prb_start + n_prb)
    rx = rx_grid if ue_index is None else rx_grid[int(ue_index)]
    return _row5_est(rx, base, refs), prbs
