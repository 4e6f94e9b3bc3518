"""The control, the reference one precision below float32 put in the
program's place, reads above the limits, at a size a test run holds (the
card's readings at the cells' own sizes come from ``python3 -m
isacbench.control`` and are in PERF.md)."""

import pytest

from isacbench.tests.test_bench_reference import run_small


@pytest.mark.parametrize("workload", ["osm-cell.drops", "hex7.steady"])
def test_control_fails_the_limits(workload):
    out, checks = run_small(workload, seed=99, controls=True)
    assert out["correct"] is True
    control = out["control"]
    for name in ("tx", "chan", "rx", "est", "ldpc"):
        assert control[name]["value"] > checks[name]["limit"], (name, control, checks)
