"""Operations and bytes one launch of the layered LDPC decoder needs, and its
roofline bound on one H100.

The decoder runs every row of the lifted base graph in each iteration, over
all n_cols * z posterior values of each codeword (TS 38.212: BG1 is 46 x 68
with 316 nonzero entries, BG2 42 x 52 with 197). Counted as in the port's
first roofline (chip_smoke.py's 0.0126 ms at 116 x BG1 Z=384 x 6
iterations): 10 float operations per edge, lane and iteration (subtract the
old message, magnitude, two running minima, sign, sign product, the
normalised product of three factors, add the new message), and every input
LLR read once and every posterior written once, 4 bytes each. The scratch
state of the check messages is not counted: the kernel keeps what it can of
it on chip, so bytes bound from below.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES_PER_S = 3.35e12

BASE_GRAPHS = {1: {"n_cols": 68, "edges": 316}, 2: {"n_cols": 52, "edges": 197}}
OPS_PER_EDGE_LANE_ITER = 10


def launch_ops(bg: int, z: int, codewords: int, n_iter: int) -> float:
    return float(OPS_PER_EDGE_LANE_ITER * BASE_GRAPHS[bg]["edges"] * z * n_iter * codewords)


def launch_bytes(bg: int, z: int, codewords: int) -> float:
    return float(2 * 4 * BASE_GRAPHS[bg]["n_cols"] * z * codewords)


def launch_bound_s(bg: int, z: int, codewords: int, n_iter: int) -> float:
    """The least time the card could take: the larger of operations over the
    float32 peak and bytes over the memory bandwidth."""
    return max(launch_ops(bg, z, codewords, n_iter) / PEAK_FLOPS_FP32,
               launch_bytes(bg, z, codewords) / PEAK_BYTES_PER_S)
