"""hex19.steady rehearsed on the CPU through the harness at a cut carrier
(12 PRB): a sound run of the 19-site, 10-UE network reads correct, and the
same run with the co-channel signals left out reads not correct. Each run is
one frame of 19 engines, a few minutes on the CPU."""

import torch

from isacbench import harness
from isacbench.tests import faults

CPU = {"n_rb_override": 12, "nfft_override": 256}
SEED = 2400000047
# one frame at 12 PRB has ~290 DL and 76 UL cross terms and ~390 decoder
# launches and blocks: sample every kind densely inside them
DENSE = {"warm_slots": 2,
         "check": {"subcarriers": 24,
                   "dl_rx": {"first": 8, "within": 280, "n": 4},
                   "ul_rx": {"first": 4, "within": 76, "n": 3},
                   "ldpc": {"first": 8, "within": 380, "n": 12},
                   "tb": {"first": 20, "within": 380, "n": 200},
                   "rxc": {"first": 8, "within": 380, "n": 6}}}


def run_small(seed=SEED):
    torch.set_num_threads(4)
    return harness.run_cell("hex19.steady", seed, 0.1, False, device="cpu", overrides=CPU,
                            traffic_patch=DENSE)


def test_hex19_reads_correct():
    out, checks = run_small()
    assert out["correct"] is True, checks
    assert out["attempted"] == 19 * 20
    assert set(checks) == {"chan", "rx", "noise", "tx", "ldpc", "tb", "dmrs", "est", "mmse",
                           "demod", "scramble", "rm", "crc"}
    assert all(c["n"] > 0 for c in checks.values())
    assert checks["chan"]["n"] > 190  # a destination's 190 bank links are compared too


def test_hex19_exchange_left_out_is_not_correct(monkeypatch):
    faults.exchange_left_out(monkeypatch)
    out, checks = run_small()
    assert out["correct"] is False
    assert checks["rx"]["value"] > checks["rx"]["limit"], checks
