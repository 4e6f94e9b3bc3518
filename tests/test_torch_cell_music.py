"""run_sensing with est_algorithm="MUSIC" (range and velocity by 2D MUSIC on
antenna 0's element-wise channel, music2D.m; DoA by MUSIC on the spatial
covariance with the eigenvalue-gap signal count) in the port's engine against
the JAX engine, on the shipped city cell at 24 PRB / nfft 512: the frame's
traces, KPIs and logs under test_torch_cell.py's rules, and every estimate
and the RMSE of the post-pass exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_cell import assert_runs_equal, run_engine

torch.set_num_threads(1)


def test_music_run_sensing_equals_jax():
    port = run_engine(True, "open_street_map_city", "MUSIC")
    jax = run_engine(False, "open_street_map_city", "MUSIC")
    assert_runs_equal(jax, port)
    (_, jr), (ts, tr) = jax, port
    assert ts.cell.gnb.radar.est_algorithm == "MUSIC"
    want = {k: np.asarray(v) for k, v in jr["sensing"]["estimates"].items()}
    got = {k: v.numpy() for k, v in tr["sensing"]["estimates"].items()}
    assert got.keys() == want.keys() and "rdm" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rj, rt = jr["sensing"]["rmse"], tr["sensing"]["rmse"]
    assert rt["numMatched"] == rj["numMatched"] >= 1
    for k in ("numDetections", "numTargets"):
        assert rt[k] == rj[k], k
    for k in ("rngRMSE", "velRMSE", "aziRMSE", "eleRMSE"):
        assert rt[k] == pytest.approx(rj[k], rel=1e-9, nan_ok=True), k
