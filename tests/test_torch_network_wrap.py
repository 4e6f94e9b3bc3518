"""The port's network at seven cells, its options and its isolated path.

- The 7-cell wraparound case of tests/test_e2e.py
  (test_seven_cell_wraparound_lockstep): multi_cell(7) on the 500 m hex grid,
  one UE per cell, 6 PRB / nfft 128, DL interference only, sensing off. The
  banks are built lazily at run(), one per destination with all 7 sources
  stacked and 6 active rows; their amplitudes, pathlosses and active rows
  equal the JAX runner's (built without running the JAX engine); the frame
  completes with one throughput per UE.
- `mesh=` runs in SyncNetworkRunner and network_simulation at a world of one
  (the meshless traces); `device=None` raises without a card.
- network_simulation with interference off runs the cells alone; on a thread
  pool (enable_parallel_sim) the results equal the sequential run's, since
  each cell owns its key stream.
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

torch.set_num_threads(1)

TINY = dict(n_rb_override=6, nfft_override=128)


def one_ue_cells(port: bool, num_cells: int) -> tuple:
    """(SimulationParameters, cells) of multi_cell with one UE per cell."""
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)
    sim = S.multi_cell(P.SimulationParameters(), num_cells=num_cells)
    for name in sim.ue:
        sim.ue[name] = P.UEParams(num_ues=1, seed=sim.ue[name].seed)
    sim.validate()
    return sim, P.assign_cell_parameters(sim)


def test_seven_cell_wraparound_lockstep():
    _, j_cells = one_ue_cells(False, 7)
    jr = j_network.SyncNetworkRunner(j_cells, enable_sensing=False, ul_interference=False,
                                     **TINY)
    jr._build_banks()
    _, cells = one_ue_cells(True, 7)
    rn = t_network.SyncNetworkRunner(cells, enable_sensing=False, ul_interference=False,
                                     device="cpu", **TINY)
    assert rn.banks is None  # lazy: nothing built before run()
    res = rn.run()
    assert len(res) == 7 and len(rn.banks) == 7
    b0 = rn.banks[0]
    assert b0.amp.shape[0] == 7 and int(b0.active.sum()) == 6
    for jb, tb in zip(jr.banks, rn.banks):
        np.testing.assert_array_equal(tb.amp, jb.amp)
        np.testing.assert_array_equal(tb.pl, jb.pl)
        np.testing.assert_array_equal(tb.active, jb.active)
    thr = np.concatenate([c["communication"]["ueDLThroughputMbps"] for c in res])
    assert thr.shape == (7,) and np.all(np.isfinite(thr)) and np.all(thr > 0)


def test_mesh_raises():
    """mesh=, which once raised NotImplementedError, runs in SyncNetworkRunner
    and network_simulation at a world of one (gloo): the DL cross terms of
    both cells come from the sharded step, and the traces equal the meshless
    run's (integers exact, SINR within 0.05 dB)."""
    import torch.distributed as dist

    from isac_tpu_torch.parallel import global_mesh, init_distributed

    runs = {}
    init_distributed(device="cpu")
    try:
        mesh = global_mesh({"cell": -1})
        for name, m in (("plain", None), ("mesh", mesh)):
            sim, cells = one_ue_cells(True, 2)
            sim.log = t_params.LogParams(enable_traces=True)
            runs[name] = t_network.network_simulation(sim, mesh=m, enable_sensing=False,
                                                      device="cpu", **TINY)
        _, cells = one_ue_cells(True, 2)
        runner = t_network.SyncNetworkRunner(cells, mesh=mesh, enable_sensing=False,
                                             device="cpu", **TINY)
        runner._build_banks()
        assert runner.mesh is mesh and runner._net_rx is not None
    finally:
        dist.destroy_process_group()
    keys = ("slot", "dir", "ue", "mcs", "n_prb", "tbs", "crc", "rv")
    for a, b in zip(runs["plain"]["cells"], runs["mesh"]["cells"]):
        ta, tb = a["communication"]["trace"], b["communication"]["trace"]
        assert len(ta) == len(tb) > 0
        for x, y in zip(ta, tb):
            assert tuple(x[k] for k in keys) == tuple(y[k] for k in keys)
            assert abs(float(x["sinr_db"]) - float(y["sinr_db"])) <= 0.05


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, _ = one_ue_cells(True, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_network.network_simulation(sim, device=None, **TINY)
    from isac_tpu_torch.api import simulate

    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(t_scenarios.single_link, **TINY)


def test_parallel_isolated_cells_equal_sequential():
    runs = {}
    for parallel in (False, True):
        sim, _ = one_ue_cells(True, 2)
        sim.log = t_params.LogParams(enable_traces=True)
        runs[parallel] = t_network.network_simulation(
            sim, enable_parallel_sim=parallel, interference=False, enable_sensing=False,
            device="cpu", **TINY)
    seq, par = runs[False], runs[True]
    for a, b in zip(seq["cells"], par["cells"]):
        assert a["cell"] == b["cell"]
        assert b["communication"]["trace"] == a["communication"]["trace"]
        assert len(a["communication"]["trace"]) > 0
        for k in ("ueDLThroughputMbps", "ueULThroughputMbps", "ueDLBLER", "ueULBLER"):
            np.testing.assert_array_equal(b["communication"][k], a["communication"][k])
    assert par["network"]["totalDLThroughputMbps"] == seq["network"]["totalDLThroughputMbps"]
