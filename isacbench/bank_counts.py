"""Operations and bytes one slot response of a network bank needs in the
cluster form, and its roofline bound on one H100.

A bank's response over L links, K subcarriers, 14 symbols and P = rx * tx
antenna pairs, from N distinct delays a link and R rays:
H[l, s, k, p] = sum_n ffc[l, k, n] g[l, n, s, p], with
g[l, n, s, p] = sum over the rays r of delay n of ft[l, s, r] c[l, r, p]
(isac_tpu_torch/sim/network.py). Counted as the least work of that form,
whatever implements it: a complex multiply-add is 8 float operations, once
per (l, k, n, s, p) for the contraction and once per (l, s, r, p) for the
fold; the response is written once, the frequency phases and the folded
coefficients are read once, 8 bytes a complex64 value. The fold's inputs
(rays and coefficients) are not counted: they are a small share of the bytes
and of the operations at the cells' sizes.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES_PER_S = 3.35e12
SYMBOLS = 14


def call_ops(links: int, subcarriers: int, delays: int, rays: int, ports: int) -> float:
    return float(8 * links * subcarriers * delays * SYMBOLS * ports
                 + 8 * links * SYMBOLS * rays * ports)


def call_bytes(links: int, subcarriers: int, delays: int, ports: int) -> float:
    return float(8 * (links * SYMBOLS * subcarriers * ports + links * subcarriers * delays
                      + links * delays * SYMBOLS * ports))


def call_bound_s(links: int, subcarriers: int, delays: int, rays: int, ports: int) -> float:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the memory bandwidth."""
    return max(call_ops(links, subcarriers, delays, rays, ports) / PEAK_FLOPS_FP32,
               call_bytes(links, subcarriers, delays, ports) / PEAK_BYTES_PER_S)
