"""The reference against the port on the CPU at a cut carrier: each cell's
whole run (set-up, window, taps, reference) reads correct, and the LDPC
reference decodes exactly as the port's plain decoder does."""

import numpy as np
import pytest
import torch

from isacbench import harness
from isacbench.reference import ldpc

CPU = {"n_rb_override": 12, "nfft_override": 256}
# every kind sampled densely, so that a small run compares many items
DENSE = {
    "osm-cell.drops": {"check": {"subcarriers": 24,
                                 "dl_rx": {"first": 4, "within": 16, "n": 4},
                                 "ul_rx": {"first": 2, "within": 4, "n": 2},
                                 "ldpc": {"first": 4, "within": 26, "n": 12},
                                 "tb": {"first": 10, "within": 60, "n": 60},
                                 "rxc": {"first": 4, "within": 26, "n": 6},
                                 "rdm": {"first": 1, "within": 1, "n": 1}}},
    "hex7.steady": {"frames": 1, "warm_slots": 2,
                    "check": {"subcarriers": 24,
                              "dl_rx": {"first": 8, "within": 100, "n": 4},
                              "ul_rx": {"first": 4, "within": 24, "n": 3},
                              "ldpc": {"first": 8, "within": 100, "n": 12},
                              "tb": {"first": 20, "within": 300, "n": 200},
                              "rxc": {"first": 8, "within": 100, "n": 6}}},
}


def run_small(workload, seed, controls=False):
    torch.set_num_threads(4)
    return harness.run_cell(workload, seed, 0.1, False, device="cpu", overrides=CPU,
                            traffic_patch=DENSE[workload], controls=controls)


@pytest.mark.parametrize("workload", ["osm-cell.drops", "hex7.steady"])
def test_cell_reads_correct(workload):
    out, checks = run_small(workload, seed=4242424242)
    assert out["correct"] is True, checks
    sensing = {"rdm", "echo", "echo_noise", "cfar", "doa"}
    assert set(checks) == {"chan", "rx", "noise", "tx", "ldpc", "tb", "dmrs", "est", "mmse",
                           "demod", "scramble", "rm", "crc"} | (
                               sensing if workload == "osm-cell.drops" else set())
    assert all(c["n"] > 0 for c in checks.values())
    if workload == "hex7.steady":
        assert checks["chan"]["n"] > 35  # the bank's links are compared too


@pytest.mark.parametrize("bg,z,b", [(1, 384, 2), (2, 52, 3), (1, 20, 5), (2, 7, 4)])
def test_ldpc_reference_equals_the_ports_plain_decoder(bg, z, b):
    from isac_tpu_torch.ops.ldpc_layered import layered_posterior

    n_cols = ldpc.SHAPES[bg][1]
    g = torch.Generator().manual_seed(bg * 1000 + z)
    llr = (torch.randn((b, n_cols * z), generator=g) * 4 + 1.5).to(torch.float32)
    llr[:, : 2 * z] = 0.0  # punctured columns
    prog = layered_posterior(llr, bg, z, 6, 0.75, impl="torch")
    ref = ldpc.posterior(llr, bg, z, 6, 0.75)
    assert torch.equal(prog.reshape(ref.shape), ref)


def test_symbol_times_match_the_numerology():
    from isacbench.reference.channel import symbol_start_times

    t = symbol_start_times(3, 4096, 30)
    fs = 4096 * 30e3
    steps = np.round(np.diff(t) * fs).astype(int)
    assert steps[0] == 4096 + 288 + 64 and set(steps[1:]) == {4096 + 288}
    assert t[0] == pytest.approx(3 * 0.5e-3)
