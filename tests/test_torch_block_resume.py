"""The port's block mode with one slot per segment, and across a checkpoint,
against its slot loop on the CPU (the counterparts of tests/test_block.py:58
with block=1, and :84).

- block_slots=1: every segment is one slot; exactly the slot loop's results.
- checkpoint: a block_slots=8 run stopped at slot 10 with results waiting on
  the device, pickled, restored into a fresh block-mode simulator and
  finished: exactly the slot loop's results.
"""

import pickle

import pytest
import torch

from isac_tpu_torch.sim.cell import CellSimulator as PortCell
from test_torch_block import assert_block_equals_loop, deep_equal, strip
from test_torch_cell import SMALL, run_engine, scenario_cell

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loop_city():
    return run_engine(True, "open_street_map_city")


def test_block1_equals_slot_loop(loop_city):
    block1 = run_engine(True, "open_street_map_city", block_slots=1)
    assert_block_equals_loop(loop_city, block1)
    assert block1[0].segment_lens == [1] * block1[0].num_slots


def test_block_checkpoint_resume_equals_slot_loop(loop_city):
    _, straight = loop_city
    cell = scenario_cell(True, "open_street_map_city")
    first = PortCell(cell, block_slots=8, device="cpu", **SMALL)
    first.run(stop_slot=10, finalize=False)
    assert first._deferred and first._sen_slots  # device results cross the boundary
    blob = pickle.dumps(first.checkpoint(next_slot=10))
    second = PortCell(cell, block_slots=8, device="cpu", **SMALL)
    resumed = second.run(start_slot=second.restore(pickle.loads(blob)))
    assert sum(first.segment_lens) == 10 and sum(second.segment_lens) == 10
    deep_equal(strip(straight), strip(resumed))
