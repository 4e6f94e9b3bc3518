"""The port's lockstep network with its DL cross terms on a mesh
(SyncNetworkRunner(mesh=), parallel/cells.py network_cross_rx), on the CPU.

Two co-channel cells of multi_cell (example_network) at 12 PRB / nfft 256
with DL + UL interference, sensing off, at a world of one (gloo on an
in-memory store): the mesh runner against the meshless one. Only the
summation order of the cross term differs, so every trace integer (slot,
direction, UE, MCS, PRBs, TBS, CRC, rv) is equal and the SINR agrees within
SINR_TOL_DB. The mesh runner must take the mesh path in every slot (its
per-destination path is made to raise), and cells that cannot stack on the
mesh axis fall back to the per-destination path with `mesh` None, as in the
reference (isac_tpu/sim/network.py:391-399).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from isac_tpu_torch.config.params import SimulationParameters, assign_cell_parameters
from isac_tpu_torch.config.scenarios import multi_cell
from isac_tpu_torch.example import example_network
from isac_tpu_torch.parallel import global_mesh, init_distributed
from isac_tpu_torch.sim.network import SyncNetworkRunner
from test_torch_cell import TRACE_INT_KEYS, assert_kpis_equal

torch.set_num_threads(1)

SINR_TOL_DB = 0.05
SMALL_NET = dict(n_rb=12, nfft=256, traces=True, sensing=False, device="cpu")


@pytest.fixture
def mesh():
    init_distributed(device="cpu")
    yield global_mesh({"cell": -1})
    dist.destroy_process_group()


def test_network_mesh_equals_meshless(mesh):
    plain = example_network(**SMALL_NET)
    meshed = example_network(mesh=mesh, **SMALL_NET)

    def host_path(*args):
        raise AssertionError("the mesh runner took the per-destination path")

    meshed._dl_ext = host_path
    want, got = plain.run(), meshed.run()
    assert meshed.mesh is mesh and meshed._net_rx is not None
    assert plain.mesh is None and plain._net_rx is None
    for ps, ms, w, g in zip(plain.sims, meshed.sims, want, got):
        tp, tm = ps.metrics.trace, ms.metrics.trace
        assert len(tm) == len(tp) > 0
        for a, b in zip(tp, tm):
            assert tuple(a[k] for k in TRACE_INT_KEYS) == tuple(b[k] for k in TRACE_INT_KEYS)
            assert abs(float(a["sinr_db"]) - float(b["sinr_db"])) <= SINR_TOL_DB, (a, b)
        assert_kpis_equal(w["communication"], g["communication"])
    ext = meshed._dl_ext_mesh(0, [{"port_grid": torch.ones_like(meshed._zero_grid(s))}
                                  for s in meshed.sims])
    assert ext.shape[0] == len(meshed.sims) and bool(ext.abs().amax() > 0)


def test_heterogeneous_cells_take_the_per_destination_path(mesh):
    """Cells on different carriers do not stack on the mesh axis: the runner
    drops the mesh when it builds its banks. Co-channel cells keep it, with
    amplitude 0 on the self pairs."""
    sim = multi_cell(SimulationParameters(), num_cells=2)
    cells = assign_cell_parameters(sim)
    tiny = dict(n_rb_override=6, nfft_override=128, enable_sensing=False, device="cpu")
    mixed = [cells[0], replace(cells[1], gnb=replace(cells[1].gnb, dl_carrier_freq=3.6e9))]
    runner = SyncNetworkRunner(mixed, mesh=mesh, **tiny)
    assert runner.mesh is mesh
    runner._build_banks()
    assert runner.mesh is None and runner._net_rx is None
    same = SyncNetworkRunner(cells, mesh=mesh, **tiny)
    same._build_banks()
    assert same.mesh is mesh
    amp = same._amp_all.numpy()
    assert amp.shape == (2, 2, 5)
    np.testing.assert_array_equal(amp[[0, 1], [0, 1]], 0.0)  # no cell interferes with itself
    assert np.all(amp[[0, 1], [1, 0]] > 0)
