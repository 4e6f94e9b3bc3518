"""The port's block mode against its slot loop in FDD on the CPU (the
counterpart of tests/test_block.py:68): both directions run every slot, so
a UL CRC is due at every next slot and a segment ends after the first slot
that carries UL or SRS; the results equal the slot loop's exactly (sensing
off, as there).
"""

import torch

from test_torch_block import assert_block_equals_loop
from test_torch_cell import run_engine

torch.set_num_threads(1)


def test_block8_fdd_equals_slot_loop():
    loop = run_engine(True, "open_street_map_city", "FDD", enable_sensing=False)
    block = run_engine(True, "open_street_map_city", "FDD", enable_sensing=False,
                       block_slots=8)
    assert_block_equals_loop(loop, block)
    assert len(block[0].segment_lens) >= block[0].num_slots // 2
