"""Co-channel UPLINK interference in the port's lockstep network (TDD,
reciprocal cross channels) against isac_tpu's.

The cell-edge case of tests/test_e2e.py (test_multicell_ul_interference_degrades_cell_edge):
two cells of multi_cell with their gNBs 120 m apart and two UEs each placed
between them, cut to 12 PRB / nfft 256, sensing off. Each gNB's uplink
receiver sums the other cell's PUSCH through the transpose of the DL bank
entry (reciprocity). The port's SyncNetworkRunner equals the JAX one's under
test_torch_cell.py's rules (traces, KPIs, logs), and the uplink term is live:
a UE's UL blocks fail that all pass with ul_interference=False.
"""

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


def cell_edge_cells(port: bool) -> list:
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)
    sim = S.multi_cell(P.SimulationParameters(), num_cells=2)
    sim.bs["cell1"] = P.GNBParams(**{**sim.bs["cell1"].__dict__, "position": (0.0, 0.0, 30.0)})
    sim.bs["cell2"] = P.GNBParams(**{**sim.bs["cell2"].__dict__, "position": (120.0, 0.0, 30.0)})
    sim.ue["cell1"] = P.UEParams(num_ues=2, position_mode="predefined",
                                 positions=np.array([[55.0, 5.0, 1.5], [65.0, -5.0, 1.5]]))
    sim.ue["cell2"] = P.UEParams(num_ues=2, position_mode="predefined",
                                 positions=np.array([[60.0, 8.0, 1.5], [52.0, -6.0, 1.5]]))
    sim.log = P.LogParams(enable_traces=True)
    sim.validate()
    return P.assign_cell_parameters(sim)


def run_runner(port: bool, **kw):
    if port:
        rn = t_network.SyncNetworkRunner(cell_edge_cells(True), enable_sensing=False,
                                         device="cpu", **SIZE, **kw)
    else:
        rn = j_network.SyncNetworkRunner(cell_edge_cells(False), enable_sensing=False,
                                         **SIZE, **kw)
    return rn, rn.run()


@pytest.fixture(scope="module")
def jax_edge():
    return run_runner(False)


@pytest.fixture(scope="module")
def port_edge():
    return run_runner(True)


def ul_bler(results) -> np.ndarray:
    return np.concatenate([r["communication"]["ueULBLER"] for r in results])


def test_cell_edge_ul_equal(jax_edge, port_edge):
    assert_cells_equal(jax_edge[1], port_edge[1])
    rn = port_edge[0]
    assert rn.ul_banks is None  # TDD: the DL banks serve the uplink by reciprocity
    assert rn.stage_s.keys() >= {"banks", "readback", "dl_tx", "dl_cross", "dl_rx", "ul_tx",
                                 "ul_cross", "ul_rx", "epilogue"}


def test_cell_edge_ul_interference_bites(port_edge):
    _, iso = run_runner(True, ul_interference=False)
    assert float(ul_bler(iso).max()) == 0.0, ul_bler(iso)
    assert float(ul_bler(port_edge[1]).max()) > 0.0, ul_bler(port_edge[1])
