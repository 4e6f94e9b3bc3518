"""The port's distribution (isac_tpu_torch/parallel/) against isac_tpu's
shard_map functions, on the CPU.

The JAX functions run on the 8-device virtual CPU mesh of tests/conftest.py;
the port runs at a world of one in this process (gloo on an in-memory
store, the group destroyed by the fixture) and at worlds of 2 and 4 in
subprocesses (tools/torch_mp_worker.py, torch only, one thread per rank),
on the same numpy inputs:

- the mesh link step at 4 PRB / 8 links / MCS 10 / 2 layers: crc_ok, TB
  bits and n_ok exact, sinr_db within 1e-3 dB (tests/test_parallel.py's
  tolerance between its serial and sharded steps);
- network_dl_step (rtol/atol 2e-4, tests/test_parallel.py:100) and
  network_cross_rx (3e-4, __graft_entry__.py:146);
- range_doppler_map_sharded at n_sym 56, n_sc 96, n_ifft 128, n_fft 64
  (rtol/atol 3e-4, tests/test_parallel.py:124);
- CellSimulator(mesh=) on the shipped city at 24 PRB against the meshless
  engine: the time-sharded RDM within 2e-5 of its maximum, the detections
  equal.

Every rank of a world returns the same global result, bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as ge
from isac_tpu.parallel import cells as j_cells
from isac_tpu.parallel import make_mesh as j_make_mesh
from isac_tpu.parallel import make_sharded_link_step, network_dl_step as j_dl_step
from isac_tpu.parallel import range_doppler_map_sharded as j_rdm_sharded
from isac_tpu_torch.parallel import (
    global_mesh,
    init_distributed,
    make_link_step,
    make_mesh,
    network_cross_rx,
    network_dl_step,
    network_dl_step_reference,
    range_doppler_map_sharded,
)
from isac_tpu_torch.phy.chains import SCHGrant

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tools" / "torch_mp_worker.py"
GRANT = {"n_prb": 4, "n_layers": 2, "mcs": 10, "n_sc_grid": 48}
N_DEV = 8  # JAX's virtual devices, the links and the cells
SINR_ATOL_DB = 1e-3
DL_TOL = 2e-4
CROSS_TOL = 3e-4
RDM_TOL = 3e-4
RDM_OF_MAX = 2e-5
RANK_TIMEOUT_S = 240


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(inputs npz path, numpy inputs, JAX results on 8 devices)."""
    g, args, _ = ge._example_link_batch(n_prb=GRANT["n_prb"], n_links=N_DEV, mcs=GRANT["mcs"],
                                        n_layers=GRANT["n_layers"])
    x = dict(zip(("tb", "w", "h", "noise"), (np.asarray(a) for a in args)))
    rng = np.random.default_rng(1)
    C, n_tx, n_rx, S, K, U = N_DEV, 2, 2, 4, 24, 3
    x.update(txg=_cplx(rng, C, n_tx, S, K), hc=_cplx(rng, C, C, S, K, n_rx, n_tx),
             gains=rng.uniform(0.0, 1.0, (C, C)).astype(np.float32),
             nz=_cplx(rng, C, n_rx, S, K) * np.float32(0.1),
             txg2=_cplx(rng, C, n_tx, 14, K), hx=_cplx(rng, C, C, U, 14, K, n_rx, n_tx),
             ampx=rng.uniform(0.0, 1.0, (C, C, U)).astype(np.float32),
             rx_grid=_cplx(rng, 2, 56, 96), tx_grid=_cplx(rng, 2, 56, 96),
             n_ifft=np.int64(128), n_fft=np.int64(64))
    link_fn, _ = make_sharded_link_step(g, mesh=j_make_mesh({"link": N_DEV}))
    mesh_c = j_make_mesh({"cell": N_DEV})
    ref = {f"link_{k}": np.asarray(v) for k, v in link_fn(*args).items()}
    ref["dl_rx"] = np.asarray(j_dl_step(mesh_c)(x["txg"], x["hc"], x["gains"], x["nz"]))
    ref["cross_ext"] = np.asarray(j_cells.network_cross_rx(mesh_c)(x["txg2"], x["hx"], x["ampx"]))
    ref["rdm"] = np.asarray(j_rdm_sharded(j_make_mesh({"time": N_DEV}), 56, 96, 128, 64)(
        x["rx_grid"], x["tx_grid"]))
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, grant=json.dumps(GRANT), **x)
    return path, x, ref


@pytest.fixture
def world_of_one():
    info = init_distributed(device="cpu")
    yield info
    dist.destroy_process_group()


def _port_outputs(x) -> dict:
    """What tools/torch_mp_worker.py computes, in this process."""
    t = {k: torch.as_tensor(np.array(v)) for k, v in x.items()}
    step, _ = make_link_step(SCHGrant(**GRANT), device="cpu", mesh=global_mesh({"link": -1}))
    out = {f"link_{k}": v.numpy() for k, v in step(t["tb"], t["w"], t["h"], t["noise"]).items()}
    mesh_c = global_mesh({"cell": -1})
    out["dl_rx"] = network_dl_step(mesh_c)(t["txg"], t["hc"], t["gains"], t["nz"]).numpy()
    out["cross_ext"] = network_cross_rx(mesh_c)(t["txg2"], t["hx"], t["ampx"]).numpy()
    out["rdm"] = range_doppler_map_sharded(global_mesh({"time": -1}), 56, 96, 128, 64)(
        t["rx_grid"], t["tx_grid"]).numpy()
    return out


def _assert_equal_to_jax(out: dict, ref: dict):
    np.testing.assert_array_equal(out["link_crc_ok"], ref["link_crc_ok"])
    np.testing.assert_array_equal(out["link_tb"], ref["link_tb"])
    np.testing.assert_allclose(out["link_sinr_db"], ref["link_sinr_db"], rtol=0,
                               atol=SINR_ATOL_DB)
    assert int(out["link_n_ok"]) == int(ref["link_n_ok"]) == N_DEV
    np.testing.assert_allclose(out["dl_rx"], ref["dl_rx"], rtol=DL_TOL, atol=DL_TOL)
    np.testing.assert_allclose(out["cross_ext"], ref["cross_ext"], rtol=CROSS_TOL,
                               atol=CROSS_TOL)
    np.testing.assert_allclose(out["rdm"], ref["rdm"], rtol=RDM_TOL, atol=RDM_TOL)


def test_world_of_one_equals_jax(case, world_of_one):
    _, x, ref = case
    _assert_equal_to_jax(_port_outputs(x), ref)


def test_sharded_steps_equal_serial_forms(case, world_of_one):
    """The mesh functions against the port's own serial forms: the meshless
    link step, network_dl_step_reference, the serial RDM and the plain
    einsum of the cross step; interference is live (zeroed cross gains
    change the result)."""
    from isac_tpu_torch.ops.sensing.rdm import range_doppler_map

    _, x, _ = case
    t = {k: torch.as_tensor(np.array(v)) for k, v in x.items()}
    out = _port_outputs(x)
    step, _ = make_link_step(SCHGrant(**GRANT), device="cpu")
    serial = step(t["tb"], t["w"], t["h"], t["noise"])
    np.testing.assert_array_equal(out["link_crc_ok"], serial["crc_ok"].numpy())
    np.testing.assert_array_equal(out["link_tb"], serial["tb"].numpy())
    np.testing.assert_array_equal(out["link_sinr_db"], serial["sinr_db"].numpy())
    ref = network_dl_step_reference(t["txg"], t["hc"], t["gains"], t["nz"]).numpy()
    np.testing.assert_array_equal(out["dl_rx"], ref)
    iso = network_dl_step_reference(t["txg"], t["hc"], torch.diag(torch.diag(t["gains"])),
                                    t["nz"]).numpy()
    assert not np.allclose(ref, iso)
    ext = torch.einsum("xtsk,dxuskat,dxu->duask", t["txg2"], t["hx"],
                       t["ampx"].to(torch.complex64)).numpy()
    np.testing.assert_array_equal(out["cross_ext"], ext)
    rdm = range_doppler_map(t["rx_grid"], t["tx_grid"], 128, 64).numpy()
    np.testing.assert_allclose(out["rdm"], rdm, rtol=RDM_TOL, atol=RDM_TOL)


def test_distributed_entry_world_of_one(world_of_one):
    assert world_of_one == {"process_id": 0, "num_processes": 1, "global_devices": 1,
                            "local_devices": 1}
    assert init_distributed(device="cpu") == world_of_one  # joined already: the same world
    mesh = global_mesh({"cell": 1, "time": -1})
    assert mesh.mesh_dim_names == ("cell", "time") and tuple(mesh.shape) == (1, 1)
    assert tuple(make_mesh().shape) == (1,) and make_mesh().mesh_dim_names == ("cell",)
    with pytest.raises(ValueError):
        global_mesh({"cell": 3})
    with pytest.raises(ValueError):
        global_mesh({"cell": -1, "time": -1})
    with pytest.raises(ValueError):
        make_mesh({"link": 2})


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh({"cell": 1})


@pytest.mark.parametrize("world", [2, 4])
def test_world_of_n_equals_jax(case, world, tmp_path):
    """`world` torch-only processes join one gloo world on localhost and run
    the sharded functions; every rank holds the JAX results, and all ranks
    hold the same bits. A rank that does not finish in RANK_TIMEOUT_S fails
    the test."""
    path, _, ref = case
    with socket.socket() as s:  # a free port for the store
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), f"localhost:{port}", str(world),
                          str(rank), str(path), str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)
    ]
    infos = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank of the world of {world} did not finish in "
                            f"{RANK_TIMEOUT_S} s")
            assert p.returncode == 0, err[-3000:]
            infos.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert sorted(i["process_id"] for i in infos) == list(range(world))
    for i in infos:
        assert (i["num_processes"], i["global_devices"], i["local_devices"]) == (world, world, 1)
        assert i["inferred_sizes"] == [2, world // 2]
        assert i["refused_cell_3"]
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for o in outs:
        _assert_equal_to_jax(o, ref)
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def test_cell_mesh_sensing_equals_meshless(world_of_one):
    """CellSimulator(mesh=) on the shipped city at 24 PRB: the engine's
    trace is the meshless run's bit for bit (the mesh touches only the
    post-pass), the time-sharded RDM is the serial map's within RDM_OF_MAX of
    its maximum (the sensing slice's tolerance), and the detections, bins
    and angles are equal."""
    from test_torch_cell import run_engine

    mesh = global_mesh({"cell": 1, "time": -1})
    plain_sim, plain = run_engine(True, "open_street_map_city")
    mesh_sim, meshed = run_engine(True, "open_street_map_city", mesh=mesh,
                                  mesh_time_axis="time")
    assert mesh_sim.mesh is mesh
    assert mesh_sim.metrics.trace == plain_sim.metrics.trace
    want, got = plain["sensing"]["estimates"], meshed["sensing"]["estimates"]
    assert int(want["valid"].sum()) >= 1
    for k in ("valid", "doa_valid", "rngEst", "velEst", "aziEst", "eleEst"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    w = want["rdm"].numpy()
    np.testing.assert_allclose(got["rdm"].numpy(), w, rtol=0, atol=RDM_OF_MAX * np.abs(w).max())
    np.testing.assert_equal(meshed["sensing"]["rmse"], plain["sensing"]["rmse"])
