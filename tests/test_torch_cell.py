"""The port's per-cell engine (isac_tpu_torch/sim/cell.py) against isac_tpu's.

Both engines run the shipped city scenario (5 UEs, one target, PF, On-Off
traffic, DDDSU, one frame) cut to 24 PRB / nfft 512, from the same seed. The
port draws the reference's noise (utils/prng.py: threefry bits exact, normals
within ~2 ulps), so the runs agree:

- per-slot traces: slot, direction, UE, MCS, PRBs, TBS, CRC and rv exact,
  post-equalisation SINR within SINR_TOL_DB (float32 sums of complex
  products in another order; measured well under 1e-3 dB);
- the communication KPIs to KPI_RTOL (exact counts divided by one duration);
- the scheduling logs (grant log, RB / MCS / CQI grids, per-slot BLER) exact;
- sensing: detections, bins and angles exact, the RDM to the sensing slice's
  2e-5 of its maximum, the peak power to rtol 1e-4.

The JAX engine compiles its programs on first use (~30 s on one CPU core), so
each JAX run sits in a module-scoped fixture. The helpers here also serve
test_torch_cell_resume.py, test_torch_cell_modes.py, test_torch_cell_duplex.py
and test_torch_cell_layouts.py.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import isac_tpu.config.params as j_params
import isac_tpu.config.scenarios as j_scenarios
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.config.scenarios as t_scenarios
from isac_tpu.sim.cell import CellSimulator as JaxCell
from isac_tpu_torch.sim.cell import CellSimulator as PortCell

torch.set_num_threads(1)

SINR_TOL_DB = 0.05
KPI_RTOL = 1e-6
RDM_TOL = 2e-5
SMALL = dict(n_rb_override=24, nfft_override=512)
TRACE_INT_KEYS = ("slot", "dir", "ue", "mcs", "n_prb", "tbs", "crc", "rv")

# engine variants: (cell transform, engine keyword arguments)
MODES = {
    "base": (None, {}),
    "AM": (None, {"rlc_mode": "AM"}),
    "fast_csi": (None, {"fast_csi": True}),
    "passthrough": (None, {"phy_mode": "passthrough"}),
    "FDD": (lambda P, c: replace(c, gnb=replace(c.gnb, duplex_mode="FDD")), {}),
    "TTI4": (lambda P, c: replace(c, gnb=replace(c.gnb, scheduling_type="symbol")), {}),
    "row5": (lambda P, c: replace(c, gnb=replace(c.gnb, antenna=P.ULA(n_v=2, polarizations=2))),
             {}),
    # range / velocity by 2D MUSIC in run_sensing, DoA as in the FFT chain
    "MUSIC": (lambda P, c: replace(c, gnb=replace(c.gnb, radar=replace(
        c.gnb.radar, est_algorithm="MUSIC"))), {}),
    # gNB at 10 dBm, UE at -35 dBm: DL and UL blocks fail and are retransmitted
    "retx": (lambda P, c: replace(c, gnb=replace(c.gnb, tx_power_dbm=10.0),
                                  ue=replace(c.ue, tx_power_dbm=-35.0)), {}),
}


def scenario_cell(port: bool, scenario: str, mode: str = "base"):
    """Cell 0 of a shipped scenario in one package, with traces on."""
    P, S = (t_params, t_scenarios) if port else (j_params, j_scenarios)
    cell = P.assign_cell_parameters(getattr(S, scenario)(P.SimulationParameters()))[0]
    cell = replace(cell, log=replace(cell.log, enable_traces=True))
    transform = MODES[mode][0]
    return cell if transform is None else transform(P, cell)


def run_engine(port: bool, scenario: str, mode: str = "base", **kw):
    """(simulator, result) of one engine run of a scenario in a mode."""
    kw = {**SMALL, **MODES[mode][1], **kw}
    if port:
        sim = PortCell(scenario_cell(True, scenario, mode), device="cpu", **kw)
    else:
        sim = JaxCell(scenario_cell(False, scenario, mode), **kw)
    return sim, sim.run()


def assert_traces_equal(want: list, got: list):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert tuple(g[k] for k in TRACE_INT_KEYS) == tuple(w[k] for k in TRACE_INT_KEYS), (g, w)
        assert abs(float(g["sinr_db"]) - float(w["sinr_db"])) <= SINR_TOL_DB, (g, w)


def assert_kpis_equal(want: dict, got: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "trace":
            continue
        g = got[k]
        if isinstance(w, (int, np.integer)):
            assert g == w, k
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=KPI_RTOL, atol=0,
                                       err_msg=k)


def assert_logs_equal(want: dict, got: dict):
    assert got["grants"] == want["grants"]
    assert len(got["grants"]) > 0
    for d in ("DL", "UL"):
        assert got[d].keys() == want[d].keys()
        for k in want[d]:
            w, g = np.asarray(want[d][k]), np.asarray(got[d][k])
            assert g.dtype == w.dtype, (d, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{d} {k}")  # NaN where idle, alike


def assert_runs_equal(jax_run, port_run):
    (js, jr), (ts, tr) = jax_run, port_run
    assert_traces_equal(js.metrics.trace, ts.metrics.trace)
    assert_kpis_equal(jr["communication"], tr["communication"])
    assert_logs_equal(jr["logs"], tr["logs"])


# ---------------------------------------------------------------- city run


@pytest.fixture(scope="module")
def jax_city():
    return run_engine(False, "open_street_map_city")


@pytest.fixture(scope="module")
def port_city():
    return run_engine(True, "open_street_map_city")


def test_city_traces_kpis_logs_equal(jax_city, port_city):
    assert_runs_equal(jax_city, port_city)
    comm = port_city[1]["communication"]
    assert np.all(comm["ueDLThroughputMbps"] > 0) and np.all(comm["ueULThroughputMbps"] > 0)


def test_city_sensing_equal(jax_city, port_city):
    (_, jr), (_, tr) = jax_city, port_city
    want = {k: np.asarray(v) for k, v in jr["sensing"]["estimates"].items()}
    got = {k: v.numpy() for k, v in tr["sensing"]["estimates"].items()}
    assert got.keys() == want.keys()
    for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst", "eleEst"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["rdm"], want["rdm"], rtol=0,
                               atol=RDM_TOL * float(np.abs(want["rdm"]).max()))
    np.testing.assert_allclose(got["peak"], want["peak"], rtol=1e-4, atol=0)
    rj, rt = jr["sensing"]["rmse"], tr["sensing"]["rmse"]
    assert rt["numMatched"] == rj["numMatched"] == 1
    for k in ("rngRMSE", "velRMSE", "aziRMSE"):
        assert rt[k] == pytest.approx(rj[k], rel=1e-9)


def test_passthrough_equal():
    """Statistical PHY: no device work; the Bernoulli CRCs, CQI walk and the
    whole control plane equal the reference's."""
    j_sim, j_res = run_engine(False, "open_street_map_city", "passthrough")
    t_sim, t_res = run_engine(True, "open_street_map_city", "passthrough")
    assert t_res["sensing"] is None and not t_sim.enable_sensing
    assert_kpis_equal(j_res["communication"], t_res["communication"])
    assert_logs_equal(j_res["logs"], t_res["logs"])
    assert np.all(t_res["communication"]["ueDLThroughputMbps"] > 0)


TINY = dict(n_rb_override=6, nfft_override=128)


@pytest.fixture(scope="module")
def port_city_tiny():
    return run_engine(True, "open_street_map_city", **TINY)


@pytest.mark.parametrize("kw", [{"mesh": True}, {"block_slots": 2}, {"block_slots": 1}],
                         ids=["mesh", "block_slots=2", "block_slots=1"])
def test_unported_options_raise(kw, port_city_tiny):
    """mesh= and block_slots >= 1, which once raised NotImplementedError, run
    on the CPU (the city at 6 PRB / nfft 128): the result equals the slot
    loop's exactly, except the time-sharded RDM of a world of one (gloo),
    which equals the serial map within RDM_TOL of its maximum with the same
    detections."""
    import torch.distributed as dist

    from isac_tpu_torch.parallel import global_mesh, init_distributed

    ref_sim, ref = port_city_tiny
    if "mesh" in kw:
        init_distributed(device="cpu")
        try:
            sim, res = run_engine(True, "open_street_map_city", **TINY,
                                  mesh=global_mesh({"cell": 1, "time": -1}))
        finally:
            dist.destroy_process_group()
    else:
        sim, res = run_engine(True, "open_street_map_city", **TINY, **kw)
        assert sum(sim.segment_lens) == sim.num_slots and max(sim.segment_lens) <= kw["block_slots"]
    assert sim.metrics.trace == ref_sim.metrics.trace and len(ref_sim.metrics.trace) > 0
    assert_kpis_equal(ref["communication"], res["communication"])
    assert_logs_equal(ref["logs"], res["logs"])
    want, got = ref["sensing"]["estimates"], res["sensing"]["estimates"]
    for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst", "eleEst"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    w = want["rdm"].numpy()
    atol = RDM_TOL * float(np.abs(w).max()) if "mesh" in kw else 0
    np.testing.assert_allclose(got["rdm"].numpy(), w, rtol=0, atol=atol)
