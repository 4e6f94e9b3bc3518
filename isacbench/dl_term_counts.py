"""Operations and bytes of one destination's DL cross term, and its
roofline bound on one H100.

The term of a destination with U UEs of rx antennas, from S source cells of
tx ports each, over K subcarriers and 14 symbols:
y[u, a, s, k] = sum_x amp[x, u] sum_t X[x, t, s, k] H[x, u, s, k, a, t]
(isac_tpu_torch/sim/network.py `_dl_ext`, inside the span
``network.dl_term``). Counted as the least work of that contraction,
whatever implements it: a complex multiply-add is 8 float operations, once
per (x, u, s, k, a, t); the bank's response is read once, the source grids
are read once and the term is written once, 8 bytes a complex64 value. The
amplitudes are left out: S x U values.
"""

from __future__ import annotations

from isacbench.bank_counts import PEAK_BYTES_PER_S, PEAK_FLOPS_FP32, SYMBOLS


def call_ops(sources: int, ues: int, subcarriers: int, rx: int, tx: int) -> float:
    return float(8 * sources * ues * SYMBOLS * subcarriers * rx * tx)


def call_bytes(sources: int, ues: int, subcarriers: int, rx: int, tx: int) -> float:
    return float(8 * (sources * ues * SYMBOLS * subcarriers * rx * tx
                      + sources * tx * SYMBOLS * subcarriers + ues * rx * SYMBOLS * subcarriers))


def call_bound_s(sources: int, ues: int, subcarriers: int, rx: int, tx: int) -> float:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the memory bandwidth."""
    return max(call_ops(sources, ues, subcarriers, rx, tx) / PEAK_FLOPS_FP32,
               call_bytes(sources, ues, subcarriers, rx, tx) / PEAK_BYTES_PER_S)
