"""The LDPC decoder's operation and byte counts give chip_smoke.py's roofline
at 116 codewords x BG1 Z=384 x 6 iterations."""

import pytest

from isacbench import ldpc_counts


def test_chip_smoke_shape():
    assert ldpc_counts.launch_ops(1, 384, 116, 6) == pytest.approx(8.45e8, rel=1e-3)
    assert ldpc_counts.launch_bytes(1, 384, 116) == pytest.approx(24.2e6, rel=2e-3)
    assert ldpc_counts.launch_bound_s(1, 384, 116, 6) == pytest.approx(0.0126e-3, rel=1e-2)


@pytest.mark.parametrize("bg,z,b,it", [(1, 384, 1, 6), (2, 52, 30, 6), (1, 64, 7, 1)])
def test_bound_is_the_larger_of_compute_and_bytes(bg, z, b, it):
    ops = ldpc_counts.launch_ops(bg, z, b, it) / ldpc_counts.PEAK_FLOPS_FP32
    mem = ldpc_counts.launch_bytes(bg, z, b) / ldpc_counts.PEAK_BYTES_PER_S
    assert ldpc_counts.launch_bound_s(bg, z, b, it) == max(ops, mem)
    assert ldpc_counts.launch_ops(bg, z, 2 * b, it) == 2 * ldpc_counts.launch_ops(bg, z, b, it)
