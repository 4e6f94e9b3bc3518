"""The port's lockstep network with cells that differ in UE count, against
isac_tpu's.

`network_simulation(multi_cell(2))` with cell 2 cut to 3 UEs
(`UEParams(num_ues=3, seed=1)`), 24 PRB / nfft 512, traces, DL + UL
interference, sensing on, seed 0. Each destination's bank is [2, U_dst]: the
5-UE and 3-UE cells' banks differ in shape, and the TDD uplink cross term of
the 3-UE cell indexes its own bank's rows. Under FDD the UL-carrier banks are
[2, 5] and drop the source rows whose UE count differs (active=False, as the
reference does at isac_tpu/sim/network.py:190). Under test_torch_network.py's
rules the port's run equals the JAX package's in both cells.
"""

import numpy as np
import pytest
import torch

import isac_tpu.config.params as j_params
import isac_tpu.sim.network as j_network
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.sim.network as t_network
from test_torch_cell import RDM_TOL, SMALL
from test_torch_network import assert_cells_equal, assert_network_equal, network_params

torch.set_num_threads(1)


def mixed_params(port: bool):
    """multi_cell(2) with traces on and cell 2 at 3 UEs, in one package."""
    P = t_params if port else j_params
    sim = network_params(port)
    sim.ue["cell2"] = P.UEParams(num_ues=3, seed=1)
    return sim


@pytest.fixture(scope="module")
def jax_mixed():
    return j_network.network_simulation(mixed_params(False), **SMALL)


def test_mixed_ue_counts_equal(jax_mixed):
    got = t_network.network_simulation(mixed_params(True), device="cpu", **SMALL)
    assert [len(c["communication"]["ueDLBLER"]) for c in got["cells"]] == [5, 3]
    assert_cells_equal(jax_mixed["cells"], got["cells"])
    assert_network_equal(jax_mixed["network"], got["network"])


def test_mixed_ue_count_banks_equal():
    """DL banks [2, 5] and [2, 3] and the FDD UL banks [2, 5], whose 3-UE
    source row is inactive: active rows, amplitudes and pathlosses exact,
    slot responses within RDM_TOL of their maximum."""
    runners = {}
    for port, (P, N) in ((False, (j_params, j_network)), (True, (t_params, t_network))):
        sim = mixed_params(port)
        sim.validate()
        cells, cross = N.resolve_los_cross(P.assign_cell_parameters(sim), sim)
        kw = dict(device="cpu") if port else {}
        rn = N.SyncNetworkRunner(cells, cross_los=cross, enable_sensing=False, **SMALL, **kw)
        rn._build_banks()
        rn._ensure_ul_banks()
        runners[port] = rn
    jr, tr = runners[False], runners[True]
    assert [b.amp.shape for b in tr.banks] == [(2, 5), (2, 3)]
    assert [b.active.tolist() for b in tr.ul_banks] == [[False, False], [True, False]]
    for kind in ("banks", "ul_banks"):
        for jb, tb in zip(getattr(jr, kind), getattr(tr, kind)):
            np.testing.assert_array_equal(tb.active, jb.active)
            np.testing.assert_array_equal(tb.pl, jb.pl)
            if kind == "banks":
                np.testing.assert_array_equal(tb.amp, jb.amp)
            want, got = np.asarray(jb.h(3)), tb.h(3).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=RDM_TOL * float(np.abs(want).max()))
