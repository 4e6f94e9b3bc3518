"""The port's batched PDSCH link step against the reference's
``make_sharded_link_step(g, mesh=None)``, on the CPU.

Both steps get the same numpy inputs (TB bits, precoders, channel, noise).
crc_ok and the decoded TBs must be equal. sinr_db (10 log10 of the mean
post-MMSE SINR) may differ by SINR_ATOL_DB: the channel estimate and the MMSE
agree to ~1e-5 relative (tests/test_torch_phy.py), i.e. ~4e-5 dB, and the
mean over the REs is summed in another order.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from isac_tpu.parallel import links as j_links
from isac_tpu.phy import chains as j_chains
from isac_tpu_torch.example import N_RX, example_link_batch, example_links
from isac_tpu_torch.ops.cdl import subcarrier_freqs
from isac_tpu_torch.ops.precoding import csirs_panel_dims, type1_codebook
from isac_tpu_torch.parallel.links import (
    batched_frequency_response,
    links_from_numpy,
    make_link_step,
)
from isac_tpu_torch.phy import chains as t_chains

torch.set_num_threads(1)

SINR_ATOL_DB = 1e-3


def _inputs(kw, n_links, seed):
    """Numpy link-step inputs for a grant: TBs, random Type-1 PRG precoders,
    the reference's CDL response over the carrier, unit-variance noise."""
    g = t_chains.SCHGrant(**kw)
    tbs = t_chains.grant_tbs(g)
    n_sc = g.n_sc_grid
    bl = j_links.stack_links(example_links(n_links, seed))
    h = np.asarray(j_links.batched_frequency_response(
        bl, np.arange(14) * (5e-4 / 14), subcarrier_freqs(n_sc, 30e3), scale=1579.0))
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, (n_links, tbs)).astype(np.int8)
    cb = type1_codebook(*csirs_panel_dims(16), g.n_layers)
    n_prg = (len(g.prbs) + 1) // 2
    w = np.stack([cb[rng.integers(0, cb.shape[0], n_prg)] for _ in range(n_links)])
    noise = ((rng.standard_normal((n_links, N_RX, 14, n_sc))
              + 1j * rng.standard_normal((n_links, N_RX, 14, n_sc))) * np.sqrt(0.5)
             ).astype(np.complex64)
    return (tb, w, h, noise), tbs


@pytest.mark.parametrize("kw,bg_z", [
    (dict(n_prb=4, mcs=10, n_sc_grid=48), (2, 80)),
    (dict(n_prb=8, mcs=19, n_layers=2, n_sc_grid=96), (1, 320)),
    (dict(prb_set=(0, 2, 3, 7), mcs=10, n_sc_grid=96), None),
])
def test_link_step_equals_reference(kw, bg_z):
    args, tbs = _inputs(kw, n_links=2, seed=0)
    fn, tbs_j = j_links.make_sharded_link_step(j_chains.SCHGrant(**kw), mesh=None)
    ref = {k: np.asarray(v) for k, v in fn(*args).items()}
    g = t_chains.SCHGrant(**kw)
    cfg = t_chains.grant_layout(g)["cfg"]
    if bg_z is not None:
        assert (cfg.bg, cfg.z) == bg_z
    step, tbs_t = make_link_step(g, device="cpu")
    out = step(*(torch.as_tensor(np.array(a)) for a in args))
    assert tbs_t == tbs_j == tbs
    np.testing.assert_array_equal(out["crc_ok"].numpy(), ref["crc_ok"])
    np.testing.assert_array_equal(out["tb"].numpy(), ref["tb"])
    np.testing.assert_allclose(out["sinr_db"].numpy(), ref["sinr_db"], rtol=0,
                               atol=SINR_ATOL_DB)
    assert out["crc_ok"].all()  # the example's links decode at this SNR
    np.testing.assert_array_equal(out["tb"].numpy(), args[0])


def test_example_inputs_equal_reference():
    """The port's example builder makes __graft_entry__'s example inputs:
    TBs, precoders and noise exactly, H to the ray-contraction tolerance
    (see tests/test_torch_phy.py)."""
    g_j, (tb, w, h, noise), tbs = ge._example_link_batch(n_prb=4, n_links=2, mcs=10)
    g_t, (tb_t, w_t, h_t, noise_t), tbs_t = example_link_batch(n_prb=4, n_links=2, mcs=10,
                                                               device="cpu")
    assert tbs_t == tbs and g_t.layout_key() == g_j.layout_key()
    np.testing.assert_array_equal(tb_t.numpy(), np.asarray(tb))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w))
    np.testing.assert_array_equal(noise_t.numpy(), np.asarray(noise))
    h = np.asarray(h)
    np.testing.assert_allclose(h_t.numpy(), h, rtol=0, atol=2e-5 * np.abs(h).max())
    # links_from_numpy on the reference's own stacked arrays gives the same H
    bl = j_links.stack_links(example_links(2, 0))
    h_r = batched_frequency_response(links_from_numpy(bl.coeff, bl.tau, bl.nu, device="cpu"),
                                     np.arange(14) * (5e-4 / 14), subcarrier_freqs(48, 30e3),
                                     scale=1579.0)
    np.testing.assert_array_equal(h_r.numpy(), h_t.numpy())


def test_entry_points_default_to_the_card():
    """device=None means CUDA: without a card the entry points raise instead
    of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so device=None is valid here")
    g = t_chains.SCHGrant(n_prb=4, mcs=10, n_sc_grid=48)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_link_step(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example_link_batch(n_prb=4, n_links=2, mcs=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        links_from_numpy(np.zeros((1, 2, 2, 3), np.complex64), np.zeros((1, 3)),
                         np.zeros((1, 3)))
