"""PDSCH/PUSCH DM-RS generation per TS 38.211 §7.4.1.1 / §6.4.1.1 (config type 1).

Replaces MATLAB nrPDSCHDMRS/nrPUSCHDMRS(+Indices) (SURVEY §2.9). Supports
mapping type A, single-symbol DM-RS, configurable additional positions, up to
4 ports (2 CDM groups x FD-OCC-2). Sequences are Gold-QPSK per symbol with
c_init = (2^17 (14 ns + l + 1)(2 NID + 1) + 2 NID + lambda) mod 2^31.

numpy copy of isac_tpu/ops/dmrs.py, kept so the port never imports isac_tpu.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from isac_tpu_torch.utils.sequences import gold_qpsk

# additional-position tables for mapping type A, 14-symbol slot (l0 = 2)
DMRS_SYMBOLS_TYPE_A = {0: (2,), 1: (2, 11), 2: (2, 7, 11), 3: (2, 5, 8, 11)}


def dmrs_symbols(mapping_type: str = "A", additional_positions: int = 1) -> tuple:
    if mapping_type != "A":
        raise NotImplementedError("mapping type B DM-RS not yet supported")
    return DMRS_SYMBOLS_TYPE_A[additional_positions]


def dmrs_cinit(slot: int, symbol: int, n_id: int, n_scid: int = 0) -> int:
    return (
        (1 << 17) * (14 * slot + symbol + 1) * (2 * n_id + 1) + 2 * n_id + n_scid
    ) % (1 << 31)


@lru_cache(maxsize=512)
def dmrs_sequence(slot: int, symbol: int, n_id: int, n_prb: int, prb_start: int = 0,
                  n_scid: int = 0) -> np.ndarray:
    """r(m) for the allocated PRBs, [6 * n_prb] complex (type 1: 6 REs/PRB/CDM grp).

    Sequence is referenced to CRB 0 (m offset = 6 * prb_start), as in the spec.
    """
    c_init = dmrs_cinit(slot, symbol, n_id, n_scid)
    return gold_qpsk(c_init, 6 * n_prb, offset_pairs=6 * prb_start)


def dmrs_port_values(r: np.ndarray, port: int) -> np.ndarray:
    """Apply the FD-OCC w_f to the base sequence for the given port (0..3).

    Ports 0/1 share CDM group 0 (delta 0), ports 2/3 group 1 (delta 1);
    w_f = (+1,+1) for even ports, (+1,-1) for odd ports over k' = 0,1.
    Sequence index m = 2n + k'.
    """
    vals = r.copy()
    if port % 2 == 1:
        vals[1::2] = -vals[1::2]
    return vals


def dmrs_re_indices(n_prb: int, prb_start: int, port: int) -> np.ndarray:
    """Subcarrier indices of the port's DM-RS REs within the full grid.

    Type 1: k = 4n + 2k' + delta, delta = CDM group = port // 2.
    """
    delta = port // 2
    n = np.arange(3 * n_prb)
    k = np.stack([4 * n + 0 + delta, 4 * n + 2 + delta], axis=-1).reshape(-1)
    return k + 12 * prb_start


def dmrs_values_for_prbs(slot: int, symbol: int, n_id: int, prb_set: tuple,
                         n_scid: int = 0) -> np.ndarray:
    """Sequence values for an arbitrary PRB set (6 values per PRB, CRB-0 ref)."""
    max_prb = max(prb_set) + 1
    r = dmrs_sequence(slot, symbol, n_id, max_prb, 0, n_scid)
    return np.concatenate([r[6 * p : 6 * p + 6] for p in prb_set])


def dmrs_re_indices_prbs(prb_set: tuple, port: int) -> np.ndarray:
    """Port DM-RS subcarriers over an arbitrary PRB set (type 1)."""
    delta = port // 2
    ks = []
    for p in prb_set:
        ks.append(12 * p + np.array([0, 2, 4, 6, 8, 10]) + delta)
    return np.concatenate(ks)


def dmrs_fill_grid_prbs(
    grid: np.ndarray,
    slot: int,
    n_id: int,
    prb_set: tuple,
    ports: tuple,
    symbols: tuple,
    power_scale: float = 1.0,
):
    """dmrs_fill_grid for an arbitrary PRB set (RBG-bitmap allocations)."""
    n_sym, n_sc = grid.shape[-2:]
    mask = np.zeros((n_sym, n_sc), bool)
    for l in symbols:
        r = dmrs_values_for_prbs(slot, l, n_id, prb_set)
        for pi, port in enumerate(ports):
            k = dmrs_re_indices_prbs(prb_set, port)
            grid[pi, l, k] = dmrs_port_values(r, port) * power_scale
        for delta in (0, 1):
            mask[l, dmrs_re_indices_prbs(prb_set, 2 * delta)] = True
    return grid, mask


def dmrs_fill_grid(
    grid: np.ndarray,
    slot: int,
    n_id: int,
    n_prb: int,
    prb_start: int,
    ports: tuple,
    symbols: tuple,
    power_scale: float = 1.0,
):
    """Write DM-RS into grid [ports..., n_sym, n_sc] (numpy, host-side setup).

    Returns (grid, dmrs_mask [n_sym, n_sc]) where mask marks DM-RS-carrying REs
    of BOTH CDM groups (numCDMGroupsWithoutData = 2: no data on DM-RS symbols'
    group REs).
    """
    n_sym, n_sc = grid.shape[-2:]
    mask = np.zeros((n_sym, n_sc), bool)
    for li, l in enumerate(symbols):
        r = dmrs_sequence(slot, l, n_id, n_prb, prb_start)
        for pi, port in enumerate(ports):
            k = dmrs_re_indices(n_prb, prb_start, port)
            grid[pi, l, k] = dmrs_port_values(r, port) * power_scale
        # both CDM groups blocked for data
        for delta in (0, 1):
            k_all = dmrs_re_indices(n_prb, prb_start, 2 * delta)
            mask[l, k_all] = True
    return grid, mask
