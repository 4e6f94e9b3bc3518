"""The port's lockstep network at seven cells against isac_tpu's.

`network_simulation(multi_cell(7))` cut to 12 PRB / nfft 256 with traces,
seed 0: one centre cell and its first ring of six co-channel interferers on
the 500 m hex grid, 5 UEs and one target a cell, the line of sight of every
serving and cross link from the synthetic city, DL + UL interference, sensing
on. Under test_torch_network.py's rules the port's run equals the JAX
package's in every cell: trace integers, KPIs, logs, the network dict, and
the sensing chain up to the eigensolver (RDM within RDM_TOL of its maximum,
detections, ranges and velocities exact).

The azimuths are held under the split rule (test_torch_network.py
`assert_sensing_split_equal`): MUSIC takes the CFAR detection count as its
signal count (isac_tpu/ops/sensing/__init__.py:70-73), and in cells 0, 1, 3
and 6 one target meets three or four detections, so the signal / noise split
falls inside a cluster of noise eigenvalues that agree to float32 rounding.
Every peak after the first then depends on the basis the eigensolver returns
for that cluster (in cells 0, 1 and 6 the JAX package's and the port's
differ; in cell 3 they agree by chance);
test_degenerate_split_moves_only_the_tail shows it with two eigensolvers on
the port's own covariance.
"""

import contextlib

import numpy as np
import pytest
import torch

import isac_tpu.config.params as j_params
import isac_tpu.config.scenarios as j_scenarios
import isac_tpu.sim.network as j_network
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.config.scenarios as t_scenarios
import isac_tpu_torch.ops.sensing as t_sensing
import isac_tpu_torch.sim.network as t_network
from isac_tpu_torch.ops.sensing.doa import _noise_subspace_spectrum, _params_scan, _pick_peaks
from test_torch_cell import assert_kpis_equal, assert_logs_equal, assert_traces_equal
from test_torch_network import (
    assert_network_equal,
    assert_sensing_split_equal,
    clean_signal_count,
)

torch.set_num_threads(1)

SEVEN = dict(n_rb_override=12, nfft_override=256)
NUM_CELLS = 7


def seven_params(port: bool):
    """multi_cell(7)'s SimulationParameters with traces on, in one package."""
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)
    sim = S.multi_cell(P.SimulationParameters(), num_cells=NUM_CELLS)
    sim.log = P.LogParams(enable_traces=True)
    return sim


@contextlib.contextmanager
def recording_music():
    """Within the block, every call of the port's music_doa is kept as
    (ra, params) in the yielded list, in call order (one per cell)."""
    seen = []
    real = t_sensing.music_doa

    def recorder(ra, params, **kw):
        seen.append((ra.detach().clone(), params))
        return real(ra, params, **kw)

    t_sensing.music_doa = recorder
    try:
        yield seen
    finally:
        t_sensing.music_doa = real


@pytest.fixture(scope="module")
def jax_seven():
    return j_network.network_simulation(seven_params(False), **SEVEN)


@pytest.fixture(scope="module")
def port_seven():
    """(result, [(ra, params)] of each cell's MUSIC call)."""
    with recording_music() as seen:
        res = t_network.network_simulation(seven_params(True), device="cpu", **SEVEN)
    assert len(seen) == NUM_CELLS
    return res, seen


def test_seven_cells_traces_kpis_logs_equal(jax_seven, port_seven):
    got = port_seven[0]
    assert len(got["cells"]) == len(jax_seven["cells"]) == NUM_CELLS
    for jr, tr in zip(jax_seven["cells"], got["cells"]):
        assert tr["cell"] == jr["cell"]
        assert_traces_equal(jr["communication"]["trace"], tr["communication"]["trace"])
        assert_kpis_equal(jr["communication"], tr["communication"])
        assert_logs_equal(jr["logs"], tr["logs"])
    assert_network_equal(jax_seven["network"], got["network"])


def test_seven_cells_sensing_equal(jax_seven, port_seven):
    """Every cell's sensing under the split rule; the run meets degenerate
    splits (m < n) in cells 0, 1, 3 and 6 and clean ones elsewhere."""
    got, seen = port_seven
    splits = [assert_sensing_split_equal(jr["sensing"], tr["sensing"], ra.numpy())
              for jr, tr, (ra, _) in zip(jax_seven["cells"], got["cells"], seen)]
    degenerate = [c for c, (m, n) in enumerate(splits) if m < n]
    assert degenerate == [0, 1, 3, 6], splits
    assert all(m >= 1 for m, _ in splits), splits


def _azimuths(ra: torch.Tensor, params, n_sig: int, solver: str) -> np.ndarray:
    """The port's MUSIC azimuths (scan grid, noise-subspace spectrum, peak
    picking) on the eigenvectors of one eigensolver."""
    if solver == "torch":
        vecs = torch.linalg.eigh(ra)[1]
    else:
        vecs = torch.as_tensor(np.linalg.eigh(ra.numpy())[1])
    scan, az, _ = _params_scan(params, ra.device)
    idx, valid = _pick_peaks(_noise_subspace_spectrum(vecs, scan, n_sig), 4)
    return np.where(valid.numpy() & (np.arange(4) < n_sig), az[idx].numpy(), np.nan)


@pytest.mark.parametrize("cell,clean", [(0, False), (2, True)], ids=["degenerate", "clean"])
def test_degenerate_split_moves_only_the_tail(port_seven, cell, clean):
    """torch.linalg.eigh and numpy.linalg.eigh on the port's own covariance:
    on cell 0 (one target, four detections, a noise cluster equal to
    float32 rounding) they agree on the first m azimuths and not on the rest;
    on cell 2 (one detection, a clean split) they agree on all of them."""
    res, seen = port_seven
    ra, params = seen[cell]
    n = min(max(int(res["cells"][cell]["sensing"]["estimates"]["valid"].sum()), 1), 4)
    m = clean_signal_count(ra.numpy(), n)
    a_torch = _azimuths(ra, params, n, "torch")
    a_numpy = _azimuths(ra, params, n, "numpy")
    np.testing.assert_array_equal(
        a_torch, res["cells"][cell]["sensing"]["estimates"]["aziEst"].numpy())
    np.testing.assert_array_equal(a_numpy[:m], a_torch[:m])
    if clean:
        assert m == n == 1
        np.testing.assert_array_equal(a_numpy, a_torch)
    else:
        assert (m, n) == (1, 4)
        assert not np.array_equal(a_numpy[m:n], a_torch[m:n]), (a_numpy, a_torch)
