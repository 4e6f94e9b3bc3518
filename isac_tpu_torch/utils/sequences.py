"""TS 38.211 §5.2.1 length-31 Gold pseudo-random sequence.

numpy copy of isac_tpu/utils/sequences.py, kept so the port never imports
isac_tpu (its package __init__ loads jax).

The reference simulator obtains scrambling / DM-RS / CSI-RS sequences implicitly
through MATLAB 5G Toolbox calls (e.g. ``nrPDSCH`` scrambling, ``nrPDSCHDMRS``); see
SURVEY.md §2.9. Here the generator is explicit and host-side (numpy): sequence
seeds (c_init) are static per (UE, slot, symbol) within a frame, so sequences are
precomputed at setup/trace time and enter jitted code as constant arrays.

Implementation note (instead of the bit-serial LFSR the standard describes): both
m-sequences satisfy lagged recurrences whose GF(2) characteristic polynomials are
sparse; squaring a GF(2) polynomial keeps it sparse, so

    x1[n + 31*2^k] = x1[n + 3*2^k] ^ x1[n]
    x2[n + 31*2^k] = x2[n + 3*2^k] ^ x2[n + 2*2^k] ^ x2[n + 2^k] ^ x2[n]

hold for every k >= 0. Extending the sequence with the largest admissible k
doubles the known prefix per numpy operation: O(log N) vector ops total.
"""

from __future__ import annotations

import numpy as np

_NC = 1600  # TS 38.211 §5.2.1 discard length


def _extend_lfsr(
    x: np.ndarray, length: int, lags: tuple[int, ...], degree: int = 31
) -> np.ndarray:
    """Extend an LFSR output prefix to `length` bits using sparse lagged recurrences.

    `lags` are the tap positions of the degree-D recurrence
    x[n+D] = XOR_j x[n + lag_j], lag_j < D (e.g. (3, 0) with D=31 for x1).
    Squaring the GF(2) characteristic polynomial keeps it sparse, so the same
    recurrence holds at stride 2^k, allowing the known prefix to roughly double
    per numpy operation (O(log N) vector ops total).
    """
    if x.ndim == 1:
        x = x[:, None]
        squeeze = True
    else:
        squeeze = False
    width = x.shape[1]
    out = np.empty((length, width), dtype=np.uint8)
    n = x.shape[0]
    out[:n] = x[:length] if n >= length else x
    max_lag = max(lags)
    while n < length:
        # Largest doubling step k such that the recurrence only reads known bits:
        # new index i in [n, n + C) reads i - (D - lag)*2^k ; need the largest
        # read (lag = max_lag) to stay < n, i.e. C <= (D - max_lag)*2^k, and the
        # smallest read (lag = 0) to be >= 0, i.e. D*2^k <= n.
        k = int(np.floor(np.log2(n // degree))) if n >= degree else 0
        step = 1 << k
        chunk = min((degree - max_lag) * step, length - n)
        acc = out[n - degree * step : n - degree * step + chunk].copy()
        for lag in lags:
            if lag:
                acc ^= out[n - (degree - lag) * step : n - (degree - lag) * step + chunk]
        out[n : n + chunk] = acc
        n += chunk
    return out[:, 0] if squeeze else out


def prbs_x1(length: int) -> np.ndarray:
    """First m-sequence: x1(0)=1, x1(1..30)=0; x1(n+31) = x1(n+3) + x1(n) mod 2."""
    init = np.zeros(31, dtype=np.uint8)
    init[0] = 1
    return _extend_lfsr(init, length, (3, 0))


def prbs_x2(c_init: int, length: int) -> np.ndarray:
    """Second m-sequence seeded by c_init; x2(n+31) = x2(n+3)+x2(n+2)+x2(n+1)+x2(n)."""
    init = ((int(c_init) >> np.arange(31)) & 1).astype(np.uint8)
    return _extend_lfsr(init, length, (3, 2, 1, 0))


def gold_sequence(c_init: int, length: int, offset: int = 0) -> np.ndarray:
    """c(n) = (x1(n+Nc) + x2(n+Nc)) mod 2 for n in [offset, offset+length)."""
    total = _NC + offset + length
    x1 = prbs_x1(total)
    x2 = prbs_x2(c_init, total)
    return (x1[_NC + offset :] ^ x2[_NC + offset :]).astype(np.uint8)


def gold_qpsk(c_init: int, length: int, offset_pairs: int = 0) -> np.ndarray:
    """Map the Gold sequence to QPSK symbols r(m) = (1-2c(2m) + j(1-2c(2m+1)))/sqrt(2).

    Used by DM-RS / CSI-RS sequence generation (TS 38.211 §7.4.1).
    """
    c = gold_sequence(c_init, 2 * length, offset=2 * offset_pairs).astype(np.float64)
    return ((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2.0)
