"""A run whose timed path is broken underneath reads as not correct: the
CPU rehearsal of each cell at a cut carrier, once per fault the cell can
have (a network of one cell has no exchange between cells; without sensing
there is no map), and once for a fault in each further stage of the transmit
and receive chains and of the sensing post-pass, caught by that stage's
number."""

import pytest

from isacbench.tests import faults
from isacbench.tests.test_bench_reference import run_small

# the drops' seed puts the target in line of sight, so the sensing faults
# have an echo and detections to break
SEED = {"osm-cell.drops": 4242424242, "hex7.steady": 20261018}
CASES = [
    ("osm-cell.drops", faults.frozen_fading, "chan"),
    ("osm-cell.drops", faults.decoder_unchanged, "ldpc"),
    ("osm-cell.drops", faults.half_batch, "ldpc"),
    ("osm-cell.drops", faults.block_altered, "tb"),
    ("osm-cell.drops", faults.map_altered, "rdm"),
    ("osm-cell.drops", faults.llrs_scaled, "demod"),
    ("osm-cell.drops", faults.half_recovered, "rm"),
    ("osm-cell.drops", faults.crc_flag_flipped, "crc"),
    ("osm-cell.drops", faults.noise_off, "noise"),
    ("osm-cell.drops", faults.modulation_wrong, "tx"),
    ("osm-cell.drops", faults.estimate_biased, "est"),
    ("osm-cell.drops", faults.echo_late, "echo"),
    ("osm-cell.drops", faults.echo_noise_off, "echo_noise"),
    ("osm-cell.drops", faults.detection_dropped, "cfar"),
    ("osm-cell.drops", faults.azimuth_turned, "doa"),
    ("hex7.steady", faults.frozen_fading, "chan"),
    ("hex7.steady", faults.noise_off, "noise"),
    ("hex7.steady", faults.modulation_wrong, "tx"),
    ("hex7.steady", faults.exchange_left_out, "rx"),
    ("hex7.steady", faults.half_batch, "ldpc"),
    ("hex7.steady", faults.block_altered, "tb"),
]


@pytest.mark.parametrize("workload,fault,number", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f, _ in CASES])
def test_fault_is_not_correct(monkeypatch, workload, fault, number):
    fault(monkeypatch)
    out, checks = run_small(workload, seed=SEED[workload])
    assert out["correct"] is False
    assert checks[number]["value"] > checks[number]["limit"], checks
