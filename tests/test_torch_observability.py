"""The port's result persistence, figures and top-level entry against isac_tpu's.

- `metrics/persist.py`: a port result (torch tensors included: the sensing
  estimates, the complex RDM) round-trips through save_result / load_result;
  a file written by either package loads in the other to an equal tree.
- `viz.py`: the four cases of tests/test_viz.py against the port (some fed
  torch tensors), and `save_all` of the port and of the JAX package on the
  same saved file write byte-identical PNGs.
- `api.py`: `simulate(single_link)` at 24 PRB / nfft 512 in the port equals
  the JAX package's (traces, KPIs, logs, network dict) under
  test_torch_cell.py's rules.
"""

import numpy as np
import pytest
import torch

import isac_tpu.api as j_api
import isac_tpu.config.params as j_params
import isac_tpu.config.scenarios as j_scenarios
import isac_tpu.metrics.persist as j_persist
import isac_tpu.viz as j_viz
import isac_tpu_torch.api as t_api
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.config.scenarios as t_scenarios
import isac_tpu_torch.metrics as t_metrics
import isac_tpu_torch.viz as t_viz
from isac_tpu_torch.metrics.kpi import ecdf
from test_torch_cell import SMALL
from test_torch_network import assert_cells_equal, assert_network_equal

torch.set_num_threads(1)


def traced(port: bool, scenario: str):
    """A scenario function of one package with traces on."""
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)

    def fn(sim):
        sim = getattr(S, scenario)(sim)
        sim.log = P.LogParams(enable_traces=True)
        return sim

    return fn


@pytest.fixture(scope="module")
def jax_link():
    return j_api.simulate(traced(False, "single_link"), **SMALL)


@pytest.fixture(scope="module")
def port_link():
    return t_api.simulate(traced(True, "single_link"), device="cpu", **SMALL)


@pytest.fixture(scope="module")
def port_sensing():
    """One port cell result with a sensing post-pass (tensors in it)."""
    res = t_api.simulate(traced(True, "sensing_only"), device="cpu", **SMALL)
    return res["cells"][0]


def assert_trees_equal(a, b, path="root"):
    """Equal plain trees: same keys, types and values; arrays by dtype and
    value, NaN where NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, path


# ------------------------------------------------------------------ simulate


def test_simulate_equal(jax_link, port_link):
    assert_cells_equal(jax_link["cells"], port_link["cells"])
    assert_network_equal(jax_link["network"], port_link["network"])
    assert port_link["cells"][0]["sensing"] is None  # single_link has no target


# --------------------------------------------------------------- persistence


def test_port_result_round_trip(tmp_path, port_sensing):
    est = port_sensing["sensing"]["estimates"]
    assert torch.is_tensor(est["rdm"]) and est["rdm"].is_complex()
    p = t_metrics.save_result(port_sensing, str(tmp_path / "cell"))
    assert p.endswith(".npz")
    back = t_metrics.load_result(p)
    for k, v in est.items():
        np.testing.assert_array_equal(back["sensing"]["estimates"][k], v.numpy(), err_msg=k)
        assert back["sensing"]["estimates"][k].dtype == v.numpy().dtype
    comm = port_sensing["communication"]
    for k in ("ueDLThroughputMbps", "ueULBLER"):
        np.testing.assert_array_equal(back["communication"][k], comm[k])
    assert back["communication"]["trace"] == comm["trace"]
    assert back["sensing"]["params"]["__dataclass__"] == "RadarDerived"
    assert back["sensing"]["rmse"]["numMatched"] == port_sensing["sensing"]["rmse"]["numMatched"]
    assert back["cell"] == port_sensing["cell"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_interchangeable(tmp_path, writer, jax_link, port_sensing):
    res = jax_link if writer == "jax" else {"cells": [port_sensing], "note": (1, None, np.nan)}
    save = (j_persist if writer == "jax" else t_metrics).save_result
    p = save(res, str(tmp_path / "r.npz"))
    assert_trees_equal(j_persist.load_result(p), t_metrics.load_result(p))


# ---------------------------------------------------------------- figures


def _synth_logs(n_slots=20, n_ues=3, n_rb=12):
    rng = np.random.default_rng(0)
    out = {"grants": []}
    for d in ("DL", "UL"):
        rb = rng.integers(0, n_ues + 1, (n_slots, n_rb)).astype(np.int16)
        bler = rng.uniform(0, 0.4, (n_slots, n_ues))
        bler[::3] = np.nan
        out[d] = {
            "rbGrid": torch.as_tensor(rb),
            "mcsGrid": rb,
            "cqiGrid": rng.integers(0, 16, (n_slots, n_ues, n_rb)).astype(np.int8),
            "slotBLER": torch.as_tensor(bler),
            "blockErrors": rng.integers(0, 3, (n_slots, n_ues)),
            "blocks": rng.integers(1, 5, (n_slots, n_ues)),
        }
    return out


def test_grid_and_bler_figures(tmp_path):
    logs = _synth_logs()
    t_viz.plot_rb_grid(logs, "DL", str(tmp_path / "rb.png"))
    t_viz.plot_cqi_grid(logs, "UL", 1, str(tmp_path / "cqi.png"))
    t_viz.plot_bler(logs, str(tmp_path / "bler.png"))
    for f in ("rb.png", "cqi.png", "bler.png"):
        assert (tmp_path / f).stat().st_size > 1000


def test_throughput_and_ecdf_figures(tmp_path):
    comm = {
        "ueDLThroughputMbps": torch.tensor([10.0, 7.5, 3.0]),
        "ueULThroughputMbps": np.array([2.0, 1.5, 0.5]),
        "ueDLGoodputMbps": np.array([9.0, 7.0, 2.5]),
        "ueULGoodputMbps": np.array([1.8, 1.2, 0.4]),
    }
    t_viz.plot_throughput(comm, str(tmp_path / "thr.png"))
    named = {"DL throughput": ecdf(np.array([1.0, 2, 3, 8])),
             "UL throughput": ecdf(np.array([0.2, 0.4, 1.1]))}
    t_viz.plot_ecdf(named, str(tmp_path / "ecdf.png"))
    assert (tmp_path / "thr.png").stat().st_size > 1000
    assert (tmp_path / "ecdf.png").stat().st_size > 1000


def test_rdm_figure_from_sensing_chain(tmp_path):
    from isac_tpu_torch.config.params import GNBParams, ULA
    from isac_tpu_torch.ops.sensing import derive_radar_params

    gnb = GNBParams(antenna=ULA(n_v=2, polarizations=1))
    p = derive_radar_params(gnb, gnb.carrier, np.array([[80.0, 10.0, 1.5]]), np.array([1.0]),
                            np.array([5.0]), 2)
    rng = np.random.default_rng(1)
    est = {
        "rdm": torch.as_tensor((rng.standard_normal((2, p.n_ifft, p.n_fft))
                                + 1j * rng.standard_normal((2, p.n_ifft, p.n_fft)))
                               .astype(np.complex64)),
        "rngEst": torch.tensor([80.5, float("nan")]),
        "velEst": torch.tensor([5.2, float("nan")]),
        "valid": torch.tensor([True, False]),
    }
    t_viz.plot_rdm({"estimates": est, "params": p}, str(tmp_path / "rdm.png"))
    assert (tmp_path / "rdm.png").stat().st_size > 1000


def test_scenario_figure(tmp_path):
    class Cell:
        def __init__(self, i):
            rng = np.random.default_rng(i)
            self.gnb_position = np.array([i * 100.0, 0.0, 25.0])
            self.ue_positions = rng.uniform(-50, 50, (4, 3)) + self.gnb_position
            self.ue_los = np.array([True, False, True, True])

    walls = torch.tensor([[[0, 0, 0], [10, 0, 0]], [[10, 0, 0], [10, 10, 0]]],
                         dtype=torch.float64)
    t_viz.plot_scenario([Cell(0), Cell(1)], str(tmp_path / "map.png"), walls=walls)
    assert (tmp_path / "map.png").stat().st_size > 1000


def test_save_all_live_result(tmp_path, port_sensing):
    paths = t_viz.save_all(port_sensing, str(tmp_path / "live"))
    assert len(paths) == 6 and paths[-1].endswith("_rdm.png")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_all_same_png_bytes(tmp_path, writer, jax_link, port_sensing):
    """Both packages' save_all replay one saved file to the same PNG bytes."""
    res = jax_link["cells"][0] if writer == "jax" else port_sensing
    p = (j_persist if writer == "jax" else t_metrics).save_result(res, str(tmp_path / "r"))
    got = t_viz.save_all(p, str(tmp_path / "port"))
    want = j_viz.save_all(p, str(tmp_path / "jax"))
    assert [g.replace("port", "jax") for g in got] == want
    assert len(got) == (5 if writer == "jax" else 6)
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g
