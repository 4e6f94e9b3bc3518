"""FDD in the port's engine against the reference engine: paired spectrum,
DL and UL in every slot, k1 and the UL CRC / SRS due slots without a TDD
pattern — single link at 24 PRB / nfft 512, traces, KPIs and logs under
test_torch_cell.py's rules.
"""

import pytest
import torch

from test_torch_cell import assert_runs_equal, run_engine

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["FDD"])
def test_mode_equals_jax(mode):
    port = run_engine(True, "single_link", mode)
    assert_runs_equal(run_engine(False, "single_link", mode), port)
    ul_slots = {g["slot"] for g in port[1]["logs"]["grants"] if g["dir"] == "UL"}
    assert len(ul_slots) > 5  # UL in slots that TDD would have made DL
