"""The port's block mode with fast_csi against its slot loop on the CPU (the
counterpart of tests/test_block.py:58 with fast_csi): truth-plus-noise CSI
and SRS measurements in place of the transmitted reference signals, with
block_slots=8; exactly the slot loop's results on every surface.
"""

import torch

from test_torch_block import assert_block_equals_loop
from test_torch_cell import run_engine

torch.set_num_threads(1)


def test_block8_fast_csi_equals_slot_loop():
    loop = run_engine(True, "open_street_map_city", "fast_csi")
    block = run_engine(True, "open_street_map_city", "fast_csi", block_slots=8)
    assert_block_equals_loop(loop, block)
    assert max(block[0].segment_lens) > 1
