"""The port's lockstep network (isac_tpu_torch/sim/network.py) against isac_tpu's.

`network_simulation(multi_cell(2))` cut to 24 PRB / nfft 512 with traces,
seed 0: two co-channel copies of the shipped cell 500 m apart, the line of
sight of every serving and cross link resolved in the synthetic city, DL and
UL interference through the cross-cell banks. Under test_torch_cell.py's
rules the port's run equals the JAX package's:

- the city's LoS map (serving and cross) exactly;
- each bank's amplitudes, pathlosses and active rows exactly (host float64 /
  float32 on both sides), its slot response within RDM_TOL of its maximum
  (float32 ray sums in another order);
- per cell: trace integers exact, SINR within SINR_TOL_DB, KPIs to KPI_RTOL,
  logs exact, sensing bins exact;
- the network dict: totals and ECDF values to KPI_RTOL, ECDF probabilities
  exactly.

Interference is live in the port: cell 1's DL BLER is above that of the same
cells run isolated (interference=False).
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
from isac_tpu_torch.sim.cell import CellSimulator as PortCell
from test_torch_cell import (
    KPI_RTOL,
    RDM_TOL,
    SMALL,
    assert_kpis_equal,
    assert_logs_equal,
    assert_traces_equal,
)

torch.set_num_threads(1)

ECDF_KEYS = ("dlThroughputECDF", "ulThroughputECDF", "dlGoodputECDF", "ulGoodputECDF",
             "dlBLERECDF", "ulBLERECDF")


def network_params(port: bool):
    """multi_cell(2)'s SimulationParameters with traces on, in one package."""
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)
    sim = S.multi_cell(P.SimulationParameters(), num_cells=2)
    sim.log = P.LogParams(enable_traces=True)
    return sim


def run_network(port: bool):
    if port:
        return t_network.network_simulation(network_params(True), device="cpu", **SMALL)
    return j_network.network_simulation(network_params(False), **SMALL)


def assert_sensing_equal(jr: dict, tr: dict):
    """Detections, bins and angles exact, RDM to RDM_TOL of its maximum."""
    want = {k: np.asarray(v) for k, v in jr["estimates"].items()}
    got = {k: v.numpy() for k, v in tr["estimates"].items()}
    assert got.keys() == want.keys()
    for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst", "eleEst"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["rdm"], want["rdm"], rtol=0,
                               atol=RDM_TOL * float(np.abs(want["rdm"]).max()))
    assert tr["rmse"]["numMatched"] == jr["rmse"]["numMatched"]


# MUSIC takes the CFAR detection count as its signal count n. The split of
# the eigenvalues of Ra at j is clean when (lam_j - lam_{j+1}) / lam_1 >=
# SPLIT_TAU: about a thousand float32 ulps of ||Ra||, so that a rounding error
# turns the subspace on either side by at most ~1e-3 rad (Davis-Kahan). Inside
# a cluster of noise eigenvalues that agree to rounding, the basis that an
# eigensolver returns is arbitrary, and so is every peak that depends on it.
SPLIT_TAU = 1e-4


def clean_signal_count(ra, n_sig: int) -> int:
    """m: the largest j <= n_sig whose eigenvalue split of `ra` is clean, or 0."""
    lam = np.linalg.eigvalsh(np.asarray(ra, np.complex128))[::-1]
    gaps = (lam[:-1] - lam[1:]) / lam[0]
    return max((j for j in range(1, n_sig + 1) if gaps[j - 1] >= SPLIT_TAU), default=0)


def assert_sensing_split_equal(jr: dict, tr: dict, ra) -> tuple:
    """assert_sensing_equal, with the azimuths held under the split rule: with
    n the signal count and m = clean_signal_count(ra, n) from the port's
    covariance `ra`, the first m azimuths are exact and the next n - m only
    finite where doa_valid is set; every other output as assert_sensing_equal
    holds it. Returns (m, n)."""
    want = {k: np.asarray(v) for k, v in jr["estimates"].items()}
    got = {k: v.numpy() for k, v in tr["estimates"].items()}
    assert got.keys() == want.keys()
    for k in ("valid", "doa_valid", "rngEst", "velEst", "eleEst"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["rdm"], want["rdm"], rtol=0,
                               atol=RDM_TOL * float(np.abs(want["rdm"]).max()))
    assert tr["rmse"]["numMatched"] == jr["rmse"]["numMatched"]
    n = int(np.clip(want["valid"].sum(), 1, len(want["aziEst"])))
    m = clean_signal_count(ra, n)
    np.testing.assert_array_equal(got["aziEst"][:m], want["aziEst"][:m], err_msg="aziEst")
    np.testing.assert_array_equal(got["aziEst"][n:], want["aziEst"][n:], err_msg="aziEst")
    doa = got["doa_valid"][m:n]
    assert np.isfinite(got["aziEst"][m:n][doa]).all() and np.isfinite(
        want["aziEst"][m:n][doa]).all()
    return m, n


def assert_cells_equal(want: list, got: list):
    assert len(got) == len(want)
    for jr, tr in zip(want, got):
        assert tr["cell"] == jr["cell"]
        assert_traces_equal(jr["communication"]["trace"], tr["communication"]["trace"])
        assert_kpis_equal(jr["communication"], tr["communication"])
        assert_logs_equal(jr["logs"], tr["logs"])
        if jr["sensing"] is None:
            assert tr["sensing"] is None
        else:
            assert_sensing_equal(jr["sensing"], tr["sensing"])


def assert_network_equal(want: dict, got: dict):
    assert got.keys() == want.keys()
    for k in ("totalDLThroughputMbps", "totalULThroughputMbps"):
        assert got[k] == pytest.approx(want[k], rel=KPI_RTOL, abs=0)
    for k in ECDF_KEYS:
        (gv, gp), (wv, wp) = got[k], want[k]
        np.testing.assert_allclose(gv, wv, rtol=KPI_RTOL, atol=0, err_msg=k)
        np.testing.assert_array_equal(gp, wp, err_msg=k)


@pytest.fixture(scope="module")
def jax_net():
    return run_network(False)


@pytest.fixture(scope="module")
def port_net():
    return run_network(True)


def test_los_resolution_equal():
    """The shipped city turns 4 of cell 1's 5 UEs to NLoS; every cross link
    is NLoS."""
    out = {}
    for port, (P, N) in ((False, (j_params, j_network)), (True, (t_params, t_network))):
        sim = network_params(port)
        sim.validate()
        out[port] = N.resolve_los_cross(P.assign_cell_parameters(sim), sim)
    (jc, jx), (tc, tx) = out[False], out[True]
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.ue_los, a.ue_los)
        np.testing.assert_array_equal(b.target_los, a.target_los)
    assert tx.keys() == jx.keys() == {(0, 1), (1, 0)}
    for k in jx:
        np.testing.assert_array_equal(tx[k], jx[k])
    assert tc[0].ue_los.tolist() == [False, False, False, False, True]
    assert tc[1].ue_los.tolist() == [False, True, True, True, False]
    assert not any(v.any() for v in tx.values())
    # resolve_los is the same cells without the cross map
    sim = network_params(True)
    for a, b in zip(tc, t_network.resolve_los(t_params.assign_cell_parameters(sim), sim)):
        np.testing.assert_array_equal(b.ue_los, a.ue_los)


def test_banks_equal():
    """Bank amplitudes / pathlosses / active rows exact, slot response within
    RDM_TOL of its maximum, for the DL bank and the FDD UL bank."""
    runners = {}
    for port, (P, N) in ((False, (j_params, j_network)), (True, (t_params, t_network))):
        sim = network_params(port)
        sim.validate()
        cells, cross = N.resolve_los_cross(P.assign_cell_parameters(sim), sim)
        kw = dict(device="cpu") if port else {}
        rn = N.SyncNetworkRunner(cells, seed=3, cross_los=cross, enable_sensing=False,
                                 **SMALL, **kw)
        rn._build_banks()
        rn._ensure_ul_banks()
        runners[port] = rn
    jr, tr = runners[False], runners[True]
    for kind in ("banks", "ul_banks"):
        for d, (jb, tb) in enumerate(zip(getattr(jr, kind), getattr(tr, kind))):
            np.testing.assert_array_equal(tb.active, jb.active)
            assert tb.active.tolist() == [s != d for s in range(2)]
            np.testing.assert_array_equal(tb.pl, jb.pl)
            assert tb.pl.dtype == jb.pl.dtype == np.float64
            if kind == "banks":
                np.testing.assert_array_equal(tb.amp, jb.amp)
                assert tb.amp.dtype == np.float32 and (tb.amp[d] == 0).all()
            rx_tx = (2, 16) if kind == "banks" else (16, 2)
            for slot in (0, 7):
                want = np.asarray(jb.h(slot))
                got = tb.h(slot).numpy()
                assert got.shape == want.shape == (2, 5, 14, 288, *rx_tx)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=RDM_TOL * float(np.abs(want).max()))


def test_network_cells_equal(jax_net, port_net):
    assert_cells_equal(jax_net["cells"], port_net["cells"])


def test_network_kpis_equal(jax_net, port_net):
    assert_network_equal(jax_net["network"], port_net["network"])


def test_interference_bites(port_net):
    """Cell 1 alone (what network_simulation(interference=False) runs for it:
    the same cell, LoS and seed): its DL blocks all pass, while the other
    cell's co-channel DL makes some of them fail in the lockstep run."""
    sim = network_params(True)
    sim.validate()
    cell = t_network.resolve_los(t_params.assign_cell_parameters(sim), sim)[0]
    iso = PortCell(cell, seed=0, enable_sensing=False, device="cpu", **SMALL).run()
    bler_int = port_net["cells"][0]["communication"]["ueDLBLER"]
    bler_iso = iso["communication"]["ueDLBLER"]
    assert float(bler_int.mean()) > float(bler_iso.mean()) == 0.0, (bler_int, bler_iso)
