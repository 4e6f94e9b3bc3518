"""Parity of the port's CSI-RS / SRS generation and estimation, CSI selection
(RI, PMI, CQI, TPMI), pathloss models and pass-through PHY with isac_tpu, on
the CPU.

Reference-signal grids, pathloss and the pass-through draws are host numpy on
both sides: exact. The estimators multiply gathered REs by a conjugated
reference (one complex product: 1-2 ulps, MUL_RTOL) or go through an FFT pair
(SRS: FFT_RTOL). precoded_sinr sums complex products in another order
than XLA and inverts a small matrix: a stated rtol. The selected indices
(RI, PMI, CQI, TPMI) are integers and must be equal on the seeded channels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.ops import csi as j_csi
from isac_tpu.ops import csirs as j_csirs
from isac_tpu.ops import pathloss as j_pl
from isac_tpu.ops import precoding as j_prec
from isac_tpu.ops import srs as j_srs
from isac_tpu.phy import passthrough as j_pt
from isac_tpu_torch.ops import csi as t_csi
from isac_tpu_torch.ops import csirs as t_csirs
from isac_tpu_torch.ops import pathloss as t_pl
from isac_tpu_torch.ops import srs as t_srs
from isac_tpu_torch.phy import passthrough as t_pt

torch.set_num_threads(1)

# one complex product per output (two real products and a sum per part, which
# XLA may fuse into an fma and PyTorch does not): 1-2 ulps of the product
MUL_RTOL = 5e-7
# float32 FFT pair of <= 128 points / sums of <= 16 complex products in
# another order: a few ulps of the largest term
FFT_RTOL = 2e-5
# post-MMSE SINR: a Gram matrix, a closed-form inverse and 1/d - 1; the
# cancellation in 1/d - 1 amplifies ulps by up to 1/d (SINR ~ 30 dB here)
SINR_RTOL = 2e-3


def _t(a):
    return torch.as_tensor(np.array(a))


def _cplx(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------------------------ CSI-RS / SRS


@pytest.mark.parametrize("row,n_ports", [(1, 1), (4, 4), (5, 4)])
def test_csirs_fill_grid_equal(row, n_ports):
    ga, ma = t_csirs.csirs_fill_grid(np.zeros((n_ports, 14, 96), np.complex64), 3, 17, 6, row=row,
                                     k0=2, prb_start=1)
    gb, mb = j_csirs.csirs_fill_grid(np.zeros((n_ports, 14, 96), np.complex64), 3, 17, 6, row=row,
                                     k0=2, prb_start=1)
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(ma, mb)
    assert t_csirs.csirs_cinit(3, 5, 17) == j_csirs.csirs_cinit(3, 5, 17)


@pytest.mark.parametrize("n_ports", [4, 16, 24])
def test_csirs_fdm_fill_and_estimate_equal(n_ports):
    """FDM fill is exact; the estimate is a gather times a conjugated
    reference (MUL_RTOL). ue_index picks the same entry."""
    n_prb, n_sc = 6, 72
    np.testing.assert_array_equal(t_csirs.csirs_fill_fdm(2, 9, n_prb, n_ports, n_sc),
                                  j_csirs.csirs_fill_fdm(2, 9, n_prb, n_ports, n_sc))
    assert t_csirs.csirs_fdm_reserved(n_ports) == j_csirs.csirs_fdm_reserved(n_ports)
    assert t_csirs.csirs_fdm_layout(n_ports) == j_csirs.csirs_fdm_layout(n_ports)
    rng = np.random.default_rng(n_ports)
    rx = _cplx(rng, 3, 2, 14, n_sc)
    for ue in (None, 2):
        want = np.asarray(j_csirs.csirs_estimate_fdm(jnp.asarray(rx if ue is not None else rx[1]),
                                                     2, 9, n_prb, n_ports, ue_index=ue))
        got = t_csirs.csirs_estimate_fdm(_t(rx if ue is not None else rx[1]), 2, 9, n_prb,
                                         n_ports, ue_index=ue).numpy()
        _close(got, want, MUL_RTOL)
    with pytest.raises(ValueError):
        t_csirs.csirs_fdm_layout(25)


def test_csirs_row5_estimate_equal():
    """Row 5: CDM-FD2 decode, (ls0 +- ls1) / 2 of two complex products."""
    rng = np.random.default_rng(4)
    rx = _cplx(rng, 2, 2, 14, 96)
    for ue in (None, 1):
        a = rx if ue is not None else rx[0]
        want, prbs_j = j_csirs.csirs_estimate_ports(jnp.asarray(a), 1, 5, 6, k0=2, prb_start=1,
                                                    ue_index=ue)
        got, prbs_t = t_csirs.csirs_estimate_ports(_t(a), 1, 5, 6, k0=2, prb_start=1, ue_index=ue)
        _close(got.numpy(), np.asarray(want), MUL_RTOL)
        np.testing.assert_array_equal(prbs_t, prbs_j)
    with pytest.raises(NotImplementedError):
        t_csirs.csirs_estimate_ports(_t(rx[0]), 1, 5, 6, row=4)


@pytest.mark.parametrize("m_zc,u", [(36, 0), (72, 3), (819, 0)])
def test_srs_sequences_equal(m_zc, u):
    np.testing.assert_array_equal(t_srs.low_papr_base_sequence(m_zc, u),
                                  j_srs.low_papr_base_sequence(m_zc, u))
    np.testing.assert_array_equal(t_srs.srs_sequence(m_zc, u, 3), j_srs.srs_sequence(m_zc, u, 3))
    np.testing.assert_array_equal(t_srs.srs_subcarriers(6, 4, 1, 2), j_srs.srs_subcarriers(6, 4, 1, 2))


@pytest.mark.parametrize("n_ports,comb_offset,per_prb", [(1, 0, False), (2, 1, True), (4, 3, True),
                                                         (2, 2, False)])
def test_srs_fill_and_estimate_equal(n_ports, comb_offset, per_prb):
    """Fill exact; the estimate is IFFT -> delay gate -> FFT over a length
    that is no power of two (comb 4 over 11 PRB: 33 points)."""
    n_prb, n_sc = 11, 144
    ga, ma = t_srs.srs_fill_grid(np.zeros((n_ports, 14, n_sc), np.complex64), n_prb,
                                 comb_offset=comb_offset, prb_start=1)
    gb, mb = j_srs.srs_fill_grid(np.zeros((n_ports, 14, n_sc), np.complex64), n_prb,
                                 comb_offset=comb_offset, prb_start=1)
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(ma, mb)
    rng = np.random.default_rng(n_ports)
    h = _cplx(rng, 3, n_ports)  # flat channel per (rx, port)
    rx = np.einsum("rp,psk->rsk", h, ga) + 0.05 * _cplx(rng, 3, 14, n_sc)
    want, ks_j = j_srs.srs_estimate_ports(jnp.asarray(rx), n_prb, n_ports, comb_offset=comb_offset,
                                          prb_start=1, per_prb=per_prb)
    got, ks_t = t_srs.srs_estimate_ports(_t(rx), n_prb, n_ports, comb_offset=comb_offset,
                                         prb_start=1, per_prb=per_prb)
    np.testing.assert_array_equal(ks_t, ks_j)
    _close(got.numpy(), np.asarray(want), FFT_RTOL)
    if n_ports <= 2:  # wide enough delay gates: the flat channel comes back
        assert np.abs(got.numpy().mean(axis=0) - h).max() < 0.15


# ------------------------------------------------------------------ CSI selection


def _channel(seed, n_re, n_rx, n_tx, k_rice=0.0):
    """A seeded frequency-selective channel [n_re, n_rx, n_tx]: 3 taps."""
    rng = np.random.default_rng(seed)
    taps = _cplx(rng, 3, n_rx, n_tx) * np.array([1.0, 0.5, 0.25])[:, None, None]
    k = np.arange(n_re)[:, None, None, None]
    ph = np.exp(-2j * np.pi * k * np.array([0, 1, 3])[None, :, None, None] / 64.0)
    h = (ph * taps[None]).sum(axis=1)
    return (h + k_rice).astype(np.complex64)


def test_subband_size_and_cqi_thresholds_equal():
    for n in (1, 23, 24, 72, 73, 144, 145, 273):
        assert t_csi.subband_size(n) == j_csi.subband_size(n)
    np.testing.assert_array_equal(t_csi.SINR_TO_CQI_DL, j_csi.SINR_TO_CQI_DL)
    np.testing.assert_array_equal(t_csi.SINR_TO_CQI_UL, j_csi.SINR_TO_CQI_UL)
    assert t_csi.CQI_TABLE == j_csi.CQI_TABLE
    x = np.concatenate([j_csi.SINR_TO_CQI_DL, j_csi.SINR_TO_CQI_DL - 0.01, [-50.0, 50.0]]
                       ).astype(np.float32)
    for tab in (j_csi.SINR_TO_CQI_DL, j_csi.SINR_TO_CQI_UL):
        np.testing.assert_array_equal(t_csi.sinr_to_cqi(_t(x), tab).numpy(),
                                      np.asarray(j_csi.sinr_to_cqi(jnp.asarray(x), tab)))


@pytest.mark.parametrize("n_rx,n_tx,rank", [(2, 4, 1), (2, 4, 2), (4, 8, 3), (4, 8, 4), (2, 16, 2)])
def test_precoded_sinr_close(n_rx, n_tx, rank):
    h = _channel(rank, 24, n_rx, n_tx)
    n1, n2 = j_prec.csirs_panel_dims(n_tx)
    cb = j_prec.type1_codebook(n1, n2, rank)
    want = np.asarray(j_csi.precoded_sinr(jnp.asarray(h), jnp.asarray(cb), 0.01))
    got = t_csi.precoded_sinr(_t(h), _t(cb), 0.01).numpy()
    assert got.shape == want.shape == (cb.shape[0], 24, rank)
    np.testing.assert_allclose(got, want, rtol=SINR_RTOL, atol=SINR_RTOL)


@pytest.mark.parametrize("seed,n_rx,n_tx,nvar", [(0, 1, 4, 0.1), (1, 2, 4, 0.01), (2, 2, 16, 1.0),
                                                 (3, 4, 8, 0.01), (4, 16, 2, 0.05), (5, 4, 4, 10.0)])
def test_ri_select_equal(seed, n_rx, n_tx, nvar):
    """Analytic eigenvalues when n_rx or n_tx is at most 2 (the UL case, 16
    receive antennas at the gNB and 2 UE ports, included), eigvalsh above."""
    h = _channel(seed, 24, n_rx, n_tx)
    want = int(j_csi.ri_select(jnp.asarray(h), nvar, max_rank=4))
    got = int(t_csi.ri_select(_t(h), nvar, max_rank=4))
    assert got == want


@pytest.mark.parametrize("seed,n_tx,rank,ng,mode", [
    (0, 4, 1, 1, 1), (1, 4, 2, 1, 1), (2, 16, 1, 1, 1), (3, 16, 2, 1, 1), (4, 8, 2, 1, 2),
    (5, 8, 1, 2, 1), (6, 8, 2, 2, 2), (7, 16, 2, 2, 1),
])
def test_dl_pmi_select_equal(seed, n_tx, rank, ng, mode):
    """PMI wideband and per subband are integers: equal. The SINR that comes
    with them holds SINR_RTOL."""
    n_rx = 2
    h = _channel(seed, 24, n_rx, n_tx, k_rice=0.3)
    if ng > 1:
        n1, n2 = {8: (2, 1), 16: (4, 1)}[n_tx]
    else:
        n1, n2 = j_prec.csirs_panel_dims(n_tx)
    sb = (np.arange(24) // 4).astype(np.int64)
    for sub in (None, sb):
        wj = j_csi.dl_pmi_select(jnp.asarray(h), 0.02, rank, n1, n2, sub, ng=ng,
                                 codebook_mode=mode)
        wt = t_csi.dl_pmi_select(_t(h), 0.02, rank, n1, n2, sub, ng=ng, codebook_mode=mode)
        assert int(wt[0]) == int(wj[0])
        np.testing.assert_array_equal(wt[1].numpy(), np.asarray(wj[1]))
        np.testing.assert_allclose(wt[2].numpy(), np.asarray(wj[2]), rtol=SINR_RTOL, atol=SINR_RTOL)


@pytest.mark.parametrize("seed,n_tx,rank", [(0, 4, 1), (1, 4, 2), (2, 16, 1), (3, 16, 2),
                                            (4, 8, 3), (5, 8, 4)])
def test_cqi_select_equal(seed, n_tx, rank):
    n_rx = 4 if rank > 2 else 2
    h = _channel(10 + seed, 48, n_rx, n_tx, k_rice=0.3)
    n1, n2 = j_prec.csirs_panel_dims(n_tx)
    sb = (np.arange(48) // 8).astype(np.int64)
    rj = j_csi.cqi_select(jnp.asarray(h), 0.01, rank, n1, n2, sb)
    rt = t_csi.cqi_select(_t(h), 0.01, rank, n1, n2, sb)
    assert rt["rank"] == rj["rank"] == rank
    for k in ("pmi_wb", "pmi_sb", "cqi_wb", "cqi_sb"):
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    # dB of a mean SINR: SINR_RTOL relative is 10*log10(1+SINR_RTOL) dB
    np.testing.assert_allclose(rt["sinr_db_sb"].numpy(), np.asarray(rj["sinr_db_sb"]), atol=0.02)


def _exact_duplicates(cb):
    return [(i, j) for i in range(cb.shape[0]) for j in range(i + 1, cb.shape[0])
            if np.array_equal(cb[i], cb[j])]


@pytest.mark.parametrize("n1,n2,rank,mode,n_tx", [(1, 1, 1, 1, 2), (1, 1, 2, 1, 2),
                                                  (2, 1, 1, 2, 4), (4, 1, 2, 2, 8)])
def test_pmi_tie_takes_lowest_index(n1, n2, rank, mode, n_tx):
    """Type-1 tables hold the same matrix under several indices (the 2-port
    table repeats its 4 co-phases for every oversampled beam; codebookMode 2
    reaches one beam from two i11 cells). Their metrics tie exactly and the
    first maximum wins on both sides: never the later copy of a duplicate."""
    cb = j_prec.type1_codebook(n1, n2, rank, codebook_mode=mode)
    dup = _exact_duplicates(cb)
    assert dup, "expected duplicate codewords in this table"
    later = {j for _, j in dup}
    h = _channel(21 + n_tx, 24, 2, n_tx, k_rice=0.5)
    sb = (np.arange(24) // 4).astype(np.int64)
    wj = j_csi.dl_pmi_select(jnp.asarray(h), 0.02, rank, n1, n2, sb, codebook_mode=mode)
    wt = t_csi.dl_pmi_select(_t(h), 0.02, rank, n1, n2, sb, codebook_mode=mode)
    assert int(wt[0]) == int(wj[0]) and int(wt[0]) not in later
    np.testing.assert_array_equal(wt[1].numpy(), np.asarray(wj[1]))
    assert not (set(wt[1].numpy().tolist()) & later)
    # an all-equal metric (zero channel): index 0 everywhere
    z = np.zeros((8, 2, n_tx), np.complex64)
    wt = t_csi.dl_pmi_select(_t(z), 1.0, rank, n1, n2, sb[:8], codebook_mode=mode)
    assert int(wt[0]) == 0 and not wt[1].numpy().any()  # what jnp.argmax gives too
    tt, _ = t_csi.ul_tpmi_select(_t(np.zeros((8, 4, 2), np.complex64)), 1.0, 1)
    assert int(tt) == 0


@pytest.mark.parametrize("seed,n_ports,rank,n_rx", [(0, 2, 1, 16), (1, 2, 2, 16), (2, 4, 1, 4),
                                                    (3, 4, 2, 4), (4, 4, 3, 4), (5, 4, 4, 8),
                                                    (6, 1, 1, 4)])
def test_ul_tpmi_select_equal(seed, n_ports, rank, n_rx):
    h = _channel(30 + seed, 24, n_rx, n_ports, k_rice=0.2)
    sb = (np.arange(24) // 4).astype(np.int64)
    for sub in (None, sb):
        tj, sj = j_csi.ul_tpmi_select(jnp.asarray(h), 0.05, rank, sub)
        tt, st = t_csi.ul_tpmi_select(_t(h), 0.05, rank, sub)
        assert int(tt) == int(tj)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=0.02)


# ------------------------------------------------------------- pathloss, passthrough


def test_pathloss_models_equal():
    """All five 38.901 models, free space and the dispatcher: float64 numpy
    on both sides, exact."""
    rng = np.random.default_rng(0)
    bs = np.array([0.0, 0.0, 25.0])
    ut = np.concatenate([rng.uniform(-3000, 3000, (200, 2)), rng.uniform(1.0, 2.5, (200, 1))], -1)
    los = rng.integers(0, 2, 200).astype(bool)
    d = rng.uniform(0.1, 5000.0, 200)
    np.testing.assert_array_equal(t_pl.fspl(d, 3.5e9), j_pl.fspl(d, 3.5e9))
    for fc in (3.5e9, 28e9):
        for model in ("fspl", "UMa", "umi", "RMa", "InH", "InF", "InF-DL", "InF-SH", "InF-DH"):
            np.testing.assert_array_equal(t_pl.pathloss(model, bs, ut, fc, los),
                                          j_pl.pathloss(model, bs, ut, fc, los), err_msg=model)
    np.testing.assert_array_equal(t_pl.pathloss_rma(bs, ut, 7e8, los, 10.0, 30.0),
                                  j_pl.pathloss_rma(bs, ut, 7e8, los, 10.0, 30.0))
    with pytest.raises(ValueError):
        t_pl.pathloss("nope", bs, ut, 3.5e9, los)


def test_passthrough_draws_equal():
    for mcs in (0, 5, 10, 19, 28):
        assert t_pt.cqi_required(mcs) == j_pt.cqi_required(mcs)
        for cqi in (1.0, 7.5, 12.0):
            for n in (1, 2, 4):
                assert t_pt.passthrough_bler(mcs, cqi, n) == j_pt.passthrough_bler(mcs, cqi, n)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    a = [t_pt.passthrough_crc(ra, 10, 7.0, 1) for _ in range(200)]
    b = [j_pt.passthrough_crc(rb, 10, 7.0, 1) for _ in range(200)]
    assert a == b and 0 < sum(a) < 200
    wa, wb = t_pt.CQIWalk(3, 24, seed=5), j_pt.CQIWalk(3, 24, seed=5)
    for i in range(60):
        np.testing.assert_array_equal(wa.report(i % 3), wb.report(i % 3))
