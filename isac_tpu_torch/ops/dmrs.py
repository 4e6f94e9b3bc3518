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


def dmrs_values_for_prbs(slot: int, symbol: int, n_id: int, prb_set: tuple,
                         n_scid: int = 0) -> np.ndarray:
    """Sequence values for an arbitrary PRB set (6 values per PRB, CRB-0 ref)."""
    max_prb = max(prb_set) + 1
    r = dmrs_sequence(slot, symbol, n_id, max_prb, 0, n_scid)
    return np.concatenate([r[6 * p : 6 * p + 6] for p in prb_set])
