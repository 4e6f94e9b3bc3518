"""The osm-cell.steady cell rehearsed on the CPU at a cut carrier (12 PRB):
set-up, the window's frames, the taps and the reference read correct, and
the window stops at the timeline's end."""

import torch

from isacbench import harness

CPU = {"n_rb_override": 12, "nfft_override": 256}
DENSE = {"frames": 2, "warm_slots": 4,
         "check": {"subcarriers": 24,
                   "dl_rx": {"first": 4, "within": 16, "n": 4},
                   "ul_rx": {"first": 2, "within": 4, "n": 2},
                   "ldpc": {"first": 4, "within": 26, "n": 12},
                   "tb": {"first": 10, "within": 60, "n": 60},
                   "rxc": {"first": 4, "within": 26, "n": 6}}}


def test_cell_steady_reads_correct():
    torch.set_num_threads(4)
    out, checks = harness.run_cell("osm-cell.steady", 4242424242, 1e3, False, device="cpu",
                                   overrides=CPU, traffic_patch=DENSE)
    assert out["correct"] is True, checks
    assert set(checks) == {"chan", "rx", "noise", "tx", "ldpc", "tb", "dmrs", "est", "mmse",
                           "demod", "scramble", "rm", "crc"}
    assert all(c["n"] > 0 for c in checks.values())
    # 40 slots: 4 warm-up, then frames of 20 until the timeline's end
    assert out["run"]["cell_slots"] == 36 and out["run"]["units"] == 2
    assert set(out["metrics"]) == {"cell_slots_per_s", "peak_mem_gib", "setup_s"}
