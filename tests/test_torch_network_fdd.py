"""FDD co-channel uplink interference in the port's lockstep network against
isac_tpu's: the non-reciprocal UL-carrier bank (_UlCrossBank).

The adversarial case of tests/test_e2e.py (test_fdd_ul_cross_interference):
two FDD cells of multi_cell (DL 3.5 GHz, UL 2.6 GHz) 500 m apart, cell 2's UEs
next to gNB 1 and cell 1's 150 m out, cut to the first two UEs of each cell
and 12 PRB / nfft 256 (FDD runs both directions in every slot, and the
per-slot cost on the CPU is what a file's time budget allows), sensing off. The UL
cross channels are built on the UL carrier with their own seeds (+500009),
lazily at the first uplink. The port's run equals the JAX one's under
test_torch_cell.py's rules, the UL banks are built and active, and the victim
cell's uplink degrades as the reference's does (its isolated BLER is < 0.1).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import isac_tpu.config.params as j_params
import isac_tpu.config.scenarios as j_scenarios
import isac_tpu.sim.network as j_network
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.config.scenarios as t_scenarios
import isac_tpu_torch.sim.network as t_network
from test_torch_network import assert_cells_equal

torch.set_num_threads(1)

SIZE = dict(n_rb_override=12, nfft_override=256)


def fdd_cells(port: bool) -> list:
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)
    sim = S.multi_cell(P.SimulationParameters(), num_cells=2)
    sim.log = P.LogParams(enable_traces=True)
    cells = P.assign_cell_parameters(sim)
    pos = [(0.0, 0.0, 30.0), (500.0, 0.0, 30.0)]
    ue_rows = [
        np.stack([[150.0 + 4 * i, 6.0 * i, 1.5] for i in range(5)]),
        np.stack([[6.0 + 2 * i, -3.0 * i, 1.5] for i in range(5)]),
    ]
    return [
        replace(c, gnb=replace(c.gnb, duplex_mode="FDD", ul_carrier_freq=2.6e9,
                               position=pos[i]),
                ue_positions=ue_rows[i][:2], ue_los=c.ue_los[:2])
        for i, c in enumerate(cells)
    ]


@pytest.fixture(scope="module")
def runs():
    jr = j_network.SyncNetworkRunner(fdd_cells(False), enable_sensing=False, **SIZE)
    tr = t_network.SyncNetworkRunner(fdd_cells(True), enable_sensing=False, device="cpu",
                                     **SIZE)
    return (jr, jr.run()), (tr, tr.run())


def test_fdd_ul_cross_equal(runs):
    (jr, jres), (tr, tres) = runs
    assert_cells_equal(jres, tres)
    assert tr.ul_banks is not None and len(tr.ul_banks) == 2
    for jb, tb in zip(jr.ul_banks, tr.ul_banks):
        np.testing.assert_array_equal(tb.active, jb.active)
        np.testing.assert_array_equal(tb.pl, jb.pl)
    assert any(b.active.any() for b in tr.ul_banks)


def test_fdd_victim_uplink_degrades(runs):
    _, (_, tres) = runs
    bler = tres[0]["communication"]["ueULBLER"]
    assert np.all(np.isfinite(bler)) and float(bler.mean()) > 0.5, bler
