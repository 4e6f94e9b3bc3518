"""The command itself: it refuses to run without a card, and on the card one
short run of each cell prints a correct result line."""

import json
import subprocess
import sys

import pytest

from isacbench import harness


def _run(workload, seconds, trace):
    return subprocess.run([sys.executable, "-m", "isacbench.run", "--workload", workload,
                           "--seed", "2147483659", "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=1200)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run("osm-cell.drops", 1, 0)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", ["osm-cell.drops", "hex7.steady"])
def test_cell_on_the_card(card, workload):
    p = _run(workload, 5, 0)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
