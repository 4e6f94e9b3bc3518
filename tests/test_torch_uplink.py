"""Parity of the port's per-grant chains (sch_transmit / sch_receive and their
batched forms, both directions, HARQ soft combining), of the remaining
receiver DSP and of the whole link loop with isac_tpu, on the CPU.

The same numpy inputs (TB bits, precoders, channels, noise, soft buffers) go
through both packages. TB bits, CRC flags and every selected index are
compared exactly. Float outputs go through sums of complex products that XLA
and PyTorch take in different orders (precoding, DFT-basis interpolation,
MMSE, fold-sums of LLRs), so they hold a scale-relative float32 tolerance;
the reference's receive runs its layered decoder through the Pallas kernel
in interpret mode, as its own tests do on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.mac import tables as j_tables
from isac_tpu.ops import cdl as j_cdl
from isac_tpu.ops import channel_est as j_ce
from isac_tpu.ops import crc as j_crc
from isac_tpu.ops import csi as j_csi
from isac_tpu.ops import csirs as j_csirs
from isac_tpu.ops import dmrs as j_dmrs
from isac_tpu.ops import modulation as j_mod
from isac_tpu.ops import precoding as j_prec
from isac_tpu.ops import srs as j_srs
from isac_tpu.parallel import links as j_links
from isac_tpu.phy import chains as j_chains
from isac_tpu_torch import example as t_ex
from isac_tpu_torch.ops import cdl as t_cdl
from isac_tpu_torch.ops import channel_est as t_ce
from isac_tpu_torch.ops import crc as t_crc
from isac_tpu_torch.ops import dmrs as t_dmrs
from isac_tpu_torch.ops import modulation as t_mod
from isac_tpu_torch.ops.transport import RV_SEQUENCE
from isac_tpu_torch.phy import chains as t_chains

torch.set_num_threads(1)

# float32 sums of complex products in a different order: a few ulps (6e-8)
# of the largest term, with headroom for sums of up to ~500 terms
SUM_RTOL = 2e-5
# soft buffers: clipped LLRs (|llr| <= 60) from 1/noise-scaled distances; the
# equalizer's ulps are amplified by the LLR slope (up to ~1e3 per unit here)
LLR_ATOL = 2e-2


def _t(a):
    return torch.as_tensor(np.array(a))


def _cplx(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _close(got, want, rtol=SUM_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _pair(**kw):
    return j_chains.SCHGrant(**kw), t_chains.SCHGrant(**kw)


def _same_rx(out_t, out_j, i=None):
    """CRC flag exact, and TB bits exact wherever the CRC passes (a decode that
    does not converge amplifies float32 ulps, so a failed TB's bits are not a
    stable output: 2 of 7680 differ in the HARQ recipe's first round); mean
    SINR within 0.01 dB; noise variance and soft buffers within the float
    tolerances."""
    pick = (lambda v: v) if i is None else (lambda v: v[i])
    assert bool(pick(out_t["crc_ok"])) == bool(pick(out_j["crc_ok"]))
    if bool(pick(out_j["crc_ok"])):
        np.testing.assert_array_equal(pick(out_t["tb"]).numpy(), np.asarray(pick(out_j["tb"])))
    assert abs(float(pick(out_t["sinr_db"])) - float(pick(out_j["sinr_db"]))) < 0.01
    np.testing.assert_allclose(float(pick(out_t["noise_var"])), float(pick(out_j["noise_var"])),
                               rtol=1e-3)
    np.testing.assert_allclose(pick(out_t["soft_buffers"]).numpy(),
                               np.asarray(pick(out_j["soft_buffers"])), rtol=0, atol=LLR_ATOL)
    assert out_t["tbs"] == out_j["tbs"]


# ------------------------------------------------------------------ transmit


@pytest.mark.parametrize("kind", ["none", "wideband", "prg_extra"])
def test_sch_transmit_kinds_equal(kind):
    """The three precoder kinds, the uplink scrambling and extra_grid."""
    rng = np.random.default_rng(3)
    extra = None
    if kind == "none":
        gj, gt = _pair(n_prb=4, prb_start=2, n_sc_grid=96, mcs=10, n_layers=2, rnti=7)
        w = None
    elif kind == "wideband":
        gj, gt = _pair(n_prb=4, prb_start=2, n_sc_grid=96, mcs=10, n_layers=2, rnti=7,
                       direction="UL", rv=2)
        w = j_prec.pusch_codebook(4, 2)[1]
    else:
        gj, gt = _pair(n_prb=4, prb_start=2, n_sc_grid=96, mcs=10, n_layers=2, rnti=7,
                       reserved_per_prb=j_csirs.csirs_fdm_reserved(4))
        w = _cplx(rng, 2, 4, 2)
        extra = j_csirs.csirs_fill_fdm(0, 1, 8, 4, 96)
    tb = rng.integers(0, 2, t_chains.grant_tbs(gt)).astype(np.int8)
    assert t_chains.grant_tbs(gt) == j_chains.grant_tbs(gj)
    want, info_j = j_chains.sch_transmit(jnp.asarray(tb), gj, w=w, extra_grid=extra)
    got, info_t = t_chains.sch_transmit(_t(tb), gt, w=w, extra_grid=extra)
    assert (info_t["tbs"], info_t["g"]) == (info_j["tbs"], info_j["g"])
    if kind == "none":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got.numpy(), np.asarray(want))
    if kind == "wideband":
        # the PUSCH c_init (rnti*2^15 + n_id) equals the PDSCH one at codeword
        # q = 0, the only codeword either chain sends: one sequence, both ways
        np.testing.assert_array_equal(t_chains._scrambling_seq(gt, info_t["g"]),
                                      j_chains._scrambling_seq(gj, info_j["g"]))
        assert t_mod.pusch_scrambling_cinit(7, 1) == j_mod.pusch_scrambling_cinit(7, 1) \
            == t_mod.pdsch_scrambling_cinit(7, 0, 1)


def test_layer_maps_and_small_helpers_equal():
    rng = np.random.default_rng(0)
    d = _cplx(rng, 2, 24)
    for n_layers in (1, 2, 3, 4):
        x = t_chains.layer_map(_t(d), n_layers)
        np.testing.assert_array_equal(x.numpy(), np.asarray(j_chains.layer_map(jnp.asarray(d), n_layers)))
        np.testing.assert_array_equal(t_chains.layer_demap(x).numpy(), d)
        np.testing.assert_array_equal(
            t_chains.layer_demap(x).numpy(),
            np.asarray(j_chains.layer_demap(jnp.asarray(x.numpy()))))
    for n in (1, 2, 5, 68):
        assert t_chains.canonical_prg_count(n) == j_chains.canonical_prg_count(n)
    for kw in (dict(n_prb=16, n_sc_grid=192, mcs=20), dict(n_prb=68, n_sc_grid=3276, mcs=27, n_layers=2)):
        gj, gt = _pair(**kw)
        assert t_chains.grant_soft_buffer_shape(gt) == j_chains.grant_soft_buffer_shape(gj)
    lg, w = _cplx(rng, 2, 14, 48), _cplx(rng, 4, 2)
    _close(t_chains._wideband_precode(_t(lg), _t(w)).numpy(),
           np.asarray(j_chains._wideband_precode(jnp.asarray(lg), jnp.asarray(w))))


# ------------------------------------------------------------------- receive


def test_harq_rv_retransmission_equal():
    """The reference's HARQ recipe (MCS 20 on 16 PRB, sigma2 0.12): the first
    PDSCH fails, RV 3 combined with its soft buffers passes; without the
    buffers the retransmission alone does not carry the TB through both."""
    kw = dict(n_prb=16, n_sc_grid=192, mcs=20, n_layers=1)
    rng = np.random.default_rng(5)
    tb = rng.integers(0, 2, t_chains.grant_tbs(t_chains.SCHGrant(**kw))).astype(np.int8)
    bufs_j = bufs_t = None
    oks = []
    for rv in RV_SEQUENCE[:3]:
        gj, gt = _pair(**kw, rv=rv)
        pg_j, _ = j_chains.sch_transmit(jnp.asarray(tb), gj)
        pg_t, _ = t_chains.sch_transmit(_t(tb), gt)
        np.testing.assert_array_equal(pg_t.numpy(), np.asarray(pg_j))
        noise = _cplx(rng, 2, 14, 192) * np.float32(np.sqrt(0.12))
        rx = np.concatenate([np.asarray(pg_j), np.asarray(pg_j) * 0.9]) + noise
        out_j = j_chains.sch_receive(jnp.asarray(rx), gj, soft_buffers=bufs_j)
        out_t = t_chains.sch_receive(_t(rx), gt, soft_buffers=bufs_t)
        _same_rx(out_t, out_j)
        oks.append(bool(out_t["crc_ok"]))
        bufs_j, bufs_t = out_j["soft_buffers"], out_t["soft_buffers"]
        if oks[-1]:
            break
    assert oks[0] is False and oks[-1] is True, oks
    np.testing.assert_array_equal(out_t["tb"].numpy(), tb)


@pytest.mark.parametrize("n_layers", [3, 4])
def test_receive_rank_3_and_4_equal(n_layers):
    """A 4-antenna UE at ranks 3 and 4: the OCC partner ports (1, 3) and the
    closed-form MMSE inverse above two layers.

    Reference behaviour, reproduced: estimate_channel_canonical applies the
    FD-OCC sign to an odd port twice (once in its reference values, once in
    the (e - o) / 2 decode), so ports 1 and 3 come back with the channel of
    ports 0 and 2 and the TB does not decode even on an ideal channel. What is
    held here is that the port does the same: transmit grid, channel estimate,
    equalized SINR and the (failing) CRC flag."""
    gj, gt = _pair(n_prb=6, n_sc_grid=72, mcs=9, n_layers=n_layers, rnti=3)
    rng = np.random.default_rng(n_layers)
    tb = rng.integers(0, 2, t_chains.grant_tbs(gt)).astype(np.int8)
    pg_t, _ = t_chains.sch_transmit(_t(tb), gt)
    pg_j, _ = j_chains.sch_transmit(jnp.asarray(tb), gj)
    np.testing.assert_array_equal(pg_t.numpy(), np.asarray(pg_j))
    h = (np.eye(4, n_layers) + 0.25 * _cplx(rng, 4, n_layers)).astype(np.complex64)
    rx = np.einsum("rl,lsk->rsk", h, pg_t.numpy()) + _cplx(rng, 4, 14, 72) * np.float32(0.03)
    lay = t_chains._layout(gt.layout_key())
    refs = t_chains._dmrs_refs(gt, lay["dsyms"])
    ports = t_chains.dmrs_ports(n_layers)
    he_j, nv_j = j_ce.estimate_channel_canonical(jnp.asarray(rx), jnp.asarray(refs), ports,
                                                 lay["dsyms"], 6)
    he_t, nv_t = t_ce.estimate_channel_canonical(_t(rx), _t(refs), ports, lay["dsyms"], 6)
    _close(he_t.numpy(), np.asarray(he_j))
    # port 1 (layer index 2) repeats port 0's channel: the doubled OCC
    np.testing.assert_allclose(he_t.numpy()[..., 2], he_t.numpy()[..., 0], atol=0.1)
    eq_j, s_j = j_ce.mmse_equalize(jnp.asarray(rx), he_j, nv_j)
    eq_t, s_t = t_ce.mmse_equalize(_t(rx), he_t, nv_t)
    np.testing.assert_allclose(10 * np.log10(s_t.numpy().mean()), 10 * np.log10(np.asarray(s_j).mean()),
                               atol=0.05)
    out_j = j_chains.sch_receive(jnp.asarray(rx), gj)
    out_t = t_chains.sch_receive(_t(rx), gt)
    assert bool(out_t["crc_ok"]) == bool(out_j["crc_ok"]) is False
    assert abs(float(out_t["sinr_db"]) - float(out_j["sinr_db"])) < 0.05
    # the >2-layer MMSE itself is sound: with the TRUE channel it separates the layers
    h_true = np.broadcast_to(h, (14, 72, 4, n_layers)).copy()
    eq, sinr = t_ce.mmse_equalize(_t(rx), _t(h_true), 0.03**2)
    eq_j2, _ = j_ce.mmse_equalize(jnp.asarray(rx), jnp.asarray(h_true), 0.03**2)
    _close(eq.numpy(), np.asarray(eq_j2), 1e-4)
    data = lay["data_syms"][0]
    np.testing.assert_allclose(eq.numpy()[:, data], pg_t.numpy()[:n_layers, data], atol=0.3)


# ------------------------------------------------------------------- batched


def _grant_set(direction, rvs, prb_sets=None, **kw):
    gs_j, gs_t = [], []
    for i, rv in enumerate(rvs):
        loc = dict(prb_set=prb_sets[i]) if prb_sets else dict(prb_start=4 * i, n_prb=4)
        gj, gt = _pair(rnti=11 + i, n_id=5, slot=3, rv=rv, direction=direction,
                       n_sc_grid=144, **loc, **kw)
        gs_j.append(gj)
        gs_t.append(gt)
    return gs_j, gs_t


def test_uplink_batch_equal():
    """PUSCH: three grants on their own PRBs and channels, reduce_sum=False,
    wideband TPMI precoders, summed at a 4-antenna gNB, received as a list."""
    gs_j, gs_t = _grant_set("UL", (0, 0, 0), mcs=12, n_layers=2)
    assert len({g.layout_key() for g in gs_t}) == 1
    rng = np.random.default_rng(8)
    tbs = [rng.integers(0, 2, t_chains.grant_tbs(gs_t[0])).astype(np.int8) for _ in gs_t]
    ws = [j_prec.pusch_codebook(2, 2)[i] for i in (0, 1, 2)]
    want = np.asarray(j_chains.sch_transmit_batch(tbs, gs_j, ws, reduce_sum=False))
    got = t_chains.sch_transmit_batch(tbs, gs_t, ws, reduce_sum=False, device="cpu")
    assert got.shape == want.shape == (3, 2, 14, 144)
    _close(got.numpy(), want)
    h = _cplx(rng, 3, 4, 2)  # per-UE flat channel to 4 gNB antennas
    rx = np.einsum("urt,utsk->rsk", h, want) + _cplx(rng, 4, 14, 144) * np.float32(0.02)
    out_j = j_chains.sch_receive_batch([jnp.asarray(rx)] * 3, gs_j, [None] * 3)
    out_t = t_chains.sch_receive_batch([_t(rx)] * 3, gs_t, [None] * 3)
    for i in range(3):
        _same_rx(out_t, out_j, i)
        np.testing.assert_array_equal(out_t["tb"][i].numpy(), tbs[i])
    assert out_t["crc_ok"].tolist() == [True, True, True]


def test_downlink_batch_mixed_rv_equal():
    """PDSCH: reduce_sum=True, per-PRG precoders, the stacked all-UE grid with
    rx_indices, and one batch that mixes new transmissions with a repeat
    (rv 0, 3, 0) whose soft buffers come from a failed first round."""
    kw = dict(mcs=20, n_layers=1)
    rng = np.random.default_rng(12)
    gs_j0, gs_t0 = _grant_set("DL", (0, 0, 0), **kw)
    tbs = [rng.integers(0, 2, t_chains.grant_tbs(gs_t0[0])).astype(np.int8) for _ in gs_t0]
    ws = [_cplx(rng, 2, 2, 1) for _ in gs_t0]
    order = np.array([2, 0, 1])  # grant i is received by UE order[i]

    def round_(gs_j, gs_t, bufs_j, bufs_t, sigma):
        want = np.asarray(j_chains.sch_transmit_batch(tbs, gs_j, ws, reduce_sum=True))
        got = t_chains.sch_transmit_batch([_t(t) for t in tbs], gs_t, [_t(w) for w in ws])
        assert got.shape == want.shape == (2, 14, 144)
        _close(got.numpy(), want)
        gains = np.array([1.0, 0.9, 1.1], np.float32)
        rx_all = np.stack([np.concatenate([want, 0.8 * want]) * gains[u]
                           + _cplx(rng, 4, 14, 144) * np.float32(sigma[u]) for u in range(3)])
        out_j = j_chains.sch_receive_batch(jnp.asarray(rx_all), gs_j, bufs_j, rx_indices=order)
        out_t = t_chains.sch_receive_batch(_t(rx_all), gs_t, bufs_t, rx_indices=order)
        for i in range(3):
            _same_rx(out_t, out_j, i)
        return out_j, out_t

    # UE 0 (which receives grant 1) is noisy: grant 1 fails at rv 0
    out_j, out_t = round_(gs_j0, gs_t0, [None] * 3, [None] * 3, (0.6, 0.05, 0.05))
    assert out_t["crc_ok"].tolist() == [True, False, True]
    gs_j1, gs_t1 = _grant_set("DL", (0, 3, 0), **kw)
    assert {g.layout_key() for g in gs_t1} == {gs_t0[0].layout_key()}
    bufs_j = [None, out_j["soft_buffers"][1], None]
    bufs_t = [None, out_t["soft_buffers"][1], None]
    out_j, out_t = round_(gs_j1, gs_t1, bufs_j, bufs_t, (0.6, 0.05, 0.05))
    assert out_t["crc_ok"].tolist() == [True, True, True]
    for i in range(3):
        np.testing.assert_array_equal(out_t["tb"][i].numpy(), tbs[i])


def test_batch_noncontiguous_and_overlapping_prbs_equal():
    """RBG-bitmap allocations that differ per grant (one scatter with a
    per-grant subcarrier index), and two grants on the SAME PRBs (MU-MIMO):
    reduce_sum adds them where they overlap."""
    sets = ((0, 2, 3, 7), (1, 4, 5, 6), (0, 2, 3, 7))
    gs_j, gs_t = _grant_set("DL", (0, 0, 0), prb_sets=sets, mcs=10, n_layers=1)
    rng = np.random.default_rng(4)
    tbs = [rng.integers(0, 2, t_chains.grant_tbs(gs_t[0])).astype(np.int8) for _ in gs_t]
    ws = [_cplx(rng, 2, 4, 1) for _ in gs_t]
    for reduce_sum in (True, False):
        want = np.asarray(j_chains.sch_transmit_batch(tbs, gs_j, ws, reduce_sum=reduce_sum))
        got = t_chains.sch_transmit_batch(tbs, gs_t, ws, reduce_sum=reduce_sum, device="cpu")
        _close(got.numpy(), want)
    # the two disjoint grants alone are decodable by their UEs
    want = np.asarray(j_chains.sch_transmit_batch(tbs[:2], gs_j[:2], ws[:2]))
    h = _cplx(rng, 2, 2, 4)
    rx_all = np.einsum("urt,tsk->ursk", h, want) + _cplx(rng, 2, 2, 14, 144) * np.float32(0.02)
    out_j = j_chains.sch_receive_batch(jnp.asarray(rx_all), gs_j[:2], [None] * 2,
                                       rx_indices=np.arange(2))
    out_t = t_chains.sch_receive_batch(_t(rx_all), gs_t[:2], [None] * 2, rx_indices=np.arange(2))
    for i in range(2):
        _same_rx(out_t, out_j, i)
        np.testing.assert_array_equal(out_t["tb"][i].numpy(), tbs[i])


# ----------------------------------------------------------------- receiver DSP


@pytest.mark.parametrize("case", ["linear", "linear_prbset_bundle", "dft", "dft_bundle", "occ_pair"])
def test_estimate_channel_dmrs_equal(case):
    kw = dict(freq_window=7, prb_set=None, bundle_sc=None, interp="linear")
    ports = (0, 2)
    if case == "linear_prbset_bundle":
        kw.update(prb_set=(0, 1, 4, 5, 6, 7), bundle_sc=24)
    elif case == "dft":
        kw.update(interp="dft")
    elif case == "dft_bundle":
        kw.update(interp="dft", bundle_sc=48)
    elif case == "occ_pair":
        ports = (0, 1, 2)
    rng = np.random.default_rng(len(case))
    n_prb, n_sc = 8, 96
    rx = _cplx(rng, 2, 14, n_sc)
    hj, nj = j_ce.estimate_channel_dmrs(jnp.asarray(rx), 2, 7, n_prb, 0, ports, (2, 11), **kw)
    ht, nt = t_ce.estimate_channel_dmrs(_t(rx), 2, 7, n_prb, 0, ports, (2, 11), **kw)
    _close(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5)


def test_channel_est_helpers_equal():
    rng = np.random.default_rng(1)
    rx = _cplx(rng, 2, 14, 48)
    ref = t_dmrs.dmrs_port_values(t_dmrs.dmrs_sequence(1, 2, 3, 4), 1)
    sc = t_dmrs.dmrs_re_indices(4, 0, 1)
    ls_j = j_ce.ls_estimate_port(jnp.asarray(rx), ref, np.array([2, 11]), sc)
    ls_t = t_ce.ls_estimate_port(_t(rx), ref, np.array([2, 11]), sc)
    _close(ls_t.numpy(), np.asarray(ls_j), 1e-6)
    for a, b in zip(t_ce.occ2_decode(ls_t), j_ce.occ2_decode(ls_j)):
        _close(a.numpy(), np.asarray(b), 1e-6)
    for window in (1, 3, 7):
        _close(t_ce.smooth_freq(ls_t, window).numpy(),
               np.asarray(j_ce.smooth_freq(jnp.asarray(ls_t.numpy()), window)), 1e-6)
    pilot_sc = sc[0::2] + 1
    hp = ls_t[..., 0::2]
    for bundle in (None, 24):
        _close(t_ce.interp_to_grid(hp, pilot_sc, np.array([2, 11]), 14, 48, bundle).numpy(),
               np.asarray(j_ce.interp_to_grid(jnp.asarray(hp.numpy()), pilot_sc, np.array([2, 11]),
                                              14, 48, bundle)), 1e-6)
    # prg_prbs is accepted (and unused) by both estimators
    refs = np.stack([t_dmrs.dmrs_sequence(1, l, 3, 4) for l in (2, 11)]).astype(np.complex64)
    a = t_ce.estimate_channel_canonical(_t(rx), _t(refs), (0,), (2, 11), 4, prg_prbs=4)
    b = j_ce.estimate_channel_canonical(jnp.asarray(rx), jnp.asarray(refs), (0,), (2, 11), 4,
                                        prg_prbs=4)
    _close(a[0].numpy(), np.asarray(b[0]))


@pytest.mark.parametrize("offset,amp", [(0, 1.0), (37, 1.0), (90, 1.0), (20, 0.0)])
def test_timing_estimate_equal(offset, amp):
    """The correlation peak's offset (an integer: equal), and 0 for a
    waveform without the reference in it (the weak-peak rule)."""
    rng = np.random.default_rng(offset)
    ref = _cplx(rng, 256)
    wf = 0.3 * _cplx(rng, 2, 1024)
    wf[:, offset: offset + 256] += amp * ref
    want = int(j_ce.timing_estimate(jnp.asarray(wf), jnp.asarray(ref), 128))
    got = t_ce.timing_estimate(_t(wf), _t(ref), 128)
    assert int(got) == want == (offset if amp else 0)


# ------------------------------------------------- remaining small ops of the slice


def test_crc_dmrs_modulation_leftovers_equal():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    for kind in ("24A", "24B", "24C", "16", "11", "6"):
        np.testing.assert_array_equal(t_crc.crc_compute_np(bits, kind), j_crc.crc_compute_np(bits, kind))
        np.testing.assert_array_equal(t_crc.crc_bitserial_reference(bits, kind),
                                      t_crc.crc_compute_np(bits, kind))
    assert t_dmrs.dmrs_symbols("A", 2) == j_dmrs.dmrs_symbols("A", 2)
    with pytest.raises(NotImplementedError):
        t_dmrs.dmrs_symbols("B")
    r = t_dmrs.dmrs_sequence(1, 2, 3, 4, 1)
    for port in range(4):
        np.testing.assert_array_equal(t_dmrs.dmrs_port_values(r, port), j_dmrs.dmrs_port_values(r, port))
        np.testing.assert_array_equal(t_dmrs.dmrs_re_indices(4, 1, port), j_dmrs.dmrs_re_indices(4, 1, port))
        np.testing.assert_array_equal(t_dmrs.dmrs_re_indices_prbs((0, 3, 4), port),
                                      j_dmrs.dmrs_re_indices_prbs((0, 3, 4), port))
    ga, ma = t_dmrs.dmrs_fill_grid(np.zeros((2, 14, 96), np.complex64), 1, 3, 4, 1, (0, 2), (2, 11))
    gb, mb = j_dmrs.dmrs_fill_grid(np.zeros((2, 14, 96), np.complex64), 1, 3, 4, 1, (0, 2), (2, 11))
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(ma, mb)
    ga, ma = t_dmrs.dmrs_fill_grid_prbs(np.zeros((2, 14, 96), np.complex64), 1, 3, (0, 3, 4), (0, 1), (2,))
    gb, mb = j_dmrs.dmrs_fill_grid_prbs(np.zeros((2, 14, 96), np.complex64), 1, 3, (0, 3, 4), (0, 1), (2,))
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(ma, mb)
    b8 = rng.integers(0, 2, 64).astype(np.int8)
    c8 = rng.integers(0, 2, 64).astype(np.uint8)
    np.testing.assert_array_equal(t_mod.scramble_bits(_t(b8), c8).numpy(),
                                  np.asarray(j_mod.scramble_bits(jnp.asarray(b8), c8)))
    llr = rng.standard_normal(64).astype(np.float32)
    llr[:4] = 0.0
    np.testing.assert_array_equal(t_mod.hard_decision(_t(llr)).numpy(),
                                  np.asarray(j_mod.hard_decision(jnp.asarray(llr))))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_gray_axis_llr_closed_equals_masked_min(m):
    """The closed-form Gray-PAM LLR equals the reference's (elementwise:
    exact) and the masked-min form of demodulate_llr (same values up to the
    rounding of squared distances)."""
    rng = np.random.default_rng(m)
    tq = (rng.uniform(-1.2, 1.2, 400) * (1 << m)).astype(np.float32)
    got = t_mod._gray_axis_llr_closed(_t(tq), m).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_mod._gray_axis_llr_closed(jnp.asarray(tq), m)))
    mod = {1: "QPSK", 2: "16QAM", 3: "64QAM", 4: "256QAM"}[m]
    scale = t_mod._QAM_SCALE[2 * m]
    sym = (tq * scale).astype(np.float32) + 0j
    llr = t_mod.demodulate_llr(_t(sym.astype(np.complex64)), 1.0, mod).numpy().reshape(-1, 2 * m)
    np.testing.assert_allclose(llr[:, 0::2] / scale**2, got, rtol=1e-4, atol=1e-3)


def test_cdl_single_link_forms_equal():
    link = t_ex.example_links(1, seed=2, n_tx=4, n_rx=2)[0]
    t = np.arange(14) * (5e-4 / 14)
    f = t_cdl.subcarrier_freqs(48, 30e3)
    np.testing.assert_array_equal(t_cdl.freq_phases(link.tau, f), j_cdl.freq_phases(link.tau, f))
    np.testing.assert_array_equal(t_cdl.time_phases(link.nu, t), j_cdl.time_phases(link.nu, t))
    hj = np.asarray(j_cdl.cdl_frequency_response(link, t, f))
    ht = t_cdl.cdl_frequency_response(link, t, f, device="cpu")
    assert ht.shape == hj.shape == (14, 48, 2, 4)
    _close(ht.numpy(), hj)
    grid = _cplx(np.random.default_rng(0), 4, 14, 48)
    _close(t_cdl.apply_channel_freq(_t(grid), ht).numpy(),
           np.asarray(j_cdl.apply_channel_freq(jnp.asarray(grid), jnp.asarray(hj))))


# ------------------------------------------------------------------- the loop


class _JaxLoop:
    """The link loop of isac_tpu_torch.example.LinkLoop built from the
    reference's functions: same numpy state (CDL ray constants, CSI-RS and
    SRS grids, noise draws, TB bits), same host decisions (the example's
    numpy helpers), the reference's device functions."""

    def __init__(self, ref: t_ex.LinkLoop):
        self.r = ref
        bl = j_links.stack_links(ref.links)
        t = np.arange(14) * (5e-4 / 14)
        self.h_dl = j_links.batched_frequency_response(bl, t, t_cdl.subcarrier_freqs(ref.n_sc, 30e3))
        self.h_ul = jnp.swapaxes(self.h_dl, -1, -2)
        self.harq = {"DL": [None] * ref.n_ues, "UL": [None] * ref.n_ues}
        self.dl_csi = self.ul_csi = None

    def csi_report(self, rng):
        r = self.r
        noise = t_ex.loop_noise(rng, (r.n_ues, r.n_ue_ants, 14, r.n_sc), r.sigma2_csi)
        rx_all = jnp.einsum("tsk,uskat->uask", jnp.asarray(r.csirs_np), self.h_dl) + noise
        out = []
        for u in range(r.n_ues):
            h = j_csirs.csirs_estimate_fdm(rx_all, r.slot, r.n_id, r.n_prb, r.n_tx, ue_index=u)
            rank = int(j_csi.ri_select(h, r.sigma2_csi, max_rank=r.max_rank))
            rep = j_csi.cqi_select(h, r.sigma2_csi, rank, r.n1, r.n2,
                                   subband_of_re=r.sb_of_prb, ng=r.ng)
            out.append({"rank": rank, "pmi_sb": np.asarray(rep["pmi_sb"]),
                        "cqi_sb": np.asarray(rep["cqi_sb"]),
                        "sinr_db_sb": np.asarray(rep["sinr_db_sb"]), "h_est": np.asarray(h)})
        self.dl_csi = out
        return out

    def srs_report(self, rng):
        r = self.r
        noise = t_ex.loop_noise(rng, (r.n_tx, 14, r.n_sc), r.sigma2_ul)
        rx = jnp.einsum("utsk,uskat->ask", jnp.asarray(r.srs_np), self.h_ul) + noise
        out = []
        for u in range(r.n_ues):
            h, _ = j_srs.srs_estimate_ports(rx, r.n_prb, r.n_ue_ants, symbol=13, comb=4,
                                            comb_offset=u % 4, per_prb=True)
            rank = int(j_csi.ri_select(h, r.sigma2_ul, max_rank=r.max_rank))
            tpmi, sdb = j_csi.ul_tpmi_select(h, r.sigma2_ul, rank, subband_of_re=r.sb_of_prb)
            out.append({"rank": rank, "tpmi": int(tpmi), "sinr_db_sb": np.asarray(sdb),
                        "cqi_sb": t_ex.loop_ul_cqi(np.asarray(sdb)), "h_est": np.asarray(h)})
        self.ul_csi = out
        return out

    def _grants(self, direction, rng):
        r = self.r
        csi = self.dl_csi if direction == "DL" else self.ul_csi
        grants, tbs, ws, bufs = [], [], [], []
        for u in range(r.n_ues):
            st = self.harq[direction][u]
            if st is None:
                rep = csi[u]
                if direction == "UL":
                    w = j_prec.pusch_codebook(r.n_ue_ants, rep["rank"])[rep["tpmi"]]
                else:
                    w = t_ex.loop_dl_precoder(j_prec.type1_codebook(r.n1, r.n2, rep["rank"]),
                                              rep["pmi_sb"], r.ue_prbs[u], r.sb_size)
                st = {"mcs": j_tables.cqi_to_mcs(int(np.floor(
                          rep["cqi_sb"][r.sb_of_prb][list(r.ue_prbs[u])].mean()))),
                      "rank": rep["rank"], "tx": 0, "bufs": None, "tb": None, "w": w}
            g = j_chains.SCHGrant(
                rnti=u + 1, n_id=r.n_id, slot=r.slot, prb_start=r.ue_prbs[u][0],
                n_prb=len(r.ue_prbs[u]), mcs=st["mcs"], n_layers=st["rank"],
                rv=RV_SEQUENCE[st["tx"]], n_sc_grid=r.n_sc, direction=direction,
                reserved_per_prb=r.reserved if direction == "DL" else ())
            if st["tb"] is None:
                st["tb"] = rng.integers(0, 2, j_chains.grant_tbs(g)).astype(np.int8)
            self.harq[direction][u] = st
            grants.append(g)
            tbs.append(st["tb"])
            ws.append(st["w"])
            bufs.append(st["bufs"])
        return grants, tbs, ws, bufs

    def _finish(self, direction, grants, tbs, outs, groups):
        recs = [None] * self.r.n_ues
        for key, idx in groups.items():
            out = outs[key]
            for j, u in enumerate(idx):
                st = self.harq[direction][u]
                ok = bool(out["crc_ok"][j])
                recs[u] = {"ue": u, "rv": grants[u].rv, "mcs": st["mcs"], "rank": st["rank"],
                           "crc_ok": ok, "tb": np.asarray(out["tb"][j]),
                           "sinr_db": float(out["sinr_db"][j])}
                if ok or st["tx"] + 1 >= len(RV_SEQUENCE):
                    self.harq[direction][u] = None
                else:
                    st["tx"] += 1
                    st["bufs"] = out["soft_buffers"][j]
        return recs

    def dl_slot(self, rng):
        r = self.r
        grants, tbs, ws, bufs = self._grants("DL", rng)
        groups = t_ex.loop_group(grants)
        port_grid = jnp.asarray(r.csirs_np)
        for idx in groups.values():
            port_grid = port_grid + j_chains.sch_transmit_batch(
                [tbs[i] for i in idx], [grants[i] for i in idx], [ws[i] for i in idx])
        noise = t_ex.loop_noise(rng, (r.n_ues, r.n_ue_ants, 14, r.n_sc), r.sigma2_dl)
        rx_all = jnp.einsum("tsk,uskat->uask", port_grid, self.h_dl) + noise
        outs = {key: j_chains.sch_receive_batch(rx_all, [grants[i] for i in idx],
                                                [bufs[i] for i in idx], rx_indices=np.asarray(idx))
                for key, idx in groups.items()}
        return self._finish("DL", grants, tbs, outs, groups)

    def ul_slot(self, rng):
        r = self.r
        grants, tbs, ws, bufs = self._grants("UL", rng)
        groups = t_ex.loop_group(grants)
        rx = jnp.asarray(t_ex.loop_noise(rng, (r.n_tx, 14, r.n_sc), r.sigma2_ul))
        for idx in groups.values():
            grids = j_chains.sch_transmit_batch(
                [tbs[i] for i in idx], [grants[i] for i in idx], [ws[i] for i in idx],
                reduce_sum=False)
            rx = rx + jnp.einsum("utsk,uskat->ask", grids, self.h_ul[np.asarray(idx)])
        outs = {key: j_chains.sch_receive_batch([rx] * len(idx), [grants[i] for i in idx],
                                                [bufs[i] for i in idx])
                for key, idx in groups.items()}
        return self._finish("UL", grants, tbs, outs, groups)


def _same_records(rt, rj):
    for a, b in zip(rt, rj):
        for k in ("ue", "rv", "mcs", "rank", "crc_ok"):
            assert a[k] == b[k], (k, a, b)
        np.testing.assert_array_equal(a["tb"], b["tb"])
        assert abs(a["sinr_db"] - b["sinr_db"]) < 0.01


def test_link_loop_equals_reference_loop():
    """example_link_loop at 24 PRB / 2 UEs / 16 gNB ports against the same
    loop built from the reference's functions: RI, subband PMI and CQI, TPMI,
    MCS, rv, CRC flags and TB bits equal in both directions over 4 DL slots
    (the first TB of one UE fails and passes on its RV-3 repeat, in the slot of
    the other UE's new TB) and 2 UL slots; one receive call per layout group."""
    loop = t_ex.example_link_loop(n_prb=24, n_ues=2, n_tx=16, n_ue_ants=2, seed=0,
                                  device="cpu")
    ref = _JaxLoop(loop)
    _close(loop.h_dl.numpy(), np.asarray(ref.h_dl))
    rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    ct, cj = loop.csi_report(rng_t), ref.csi_report(rng_j)
    for a, b in zip(ct, cj):
        assert a["rank"] == b["rank"]
        np.testing.assert_array_equal(a["pmi_sb"], b["pmi_sb"])
        np.testing.assert_array_equal(a["cqi_sb"], b["cqi_sb"])
        np.testing.assert_allclose(a["sinr_db_sb"], b["sinr_db_sb"], atol=0.02)
        _close(a["h_est"].numpy(), b["h_est"])
    seen, n_groups = [], 0
    for _ in range(4):
        rt, rj = loop.dl_slot(rng_t), ref.dl_slot(rng_j)
        _same_records(rt, rj)
        n_groups += len({(r["mcs"], r["rank"]) for r in rt})
        seen.append([(r["rv"], r["crc_ok"]) for r in rt])
        assert all(r["tb_equal"] for r in rt if r["crc_ok"])
    flat = [x for s in seen for x in s]
    assert (0, False) in flat and (3, True) in flat, seen
    assert any({rv for rv, _ in s} == {0, 3} for s in seen), seen  # a mixed-rv slot
    st, sj = loop.srs_report(rng_t), ref.srs_report(rng_j)
    for a, b in zip(st, sj):
        assert (a["rank"], a["tpmi"]) == (b["rank"], b["tpmi"])
        np.testing.assert_array_equal(a["cqi_sb"], b["cqi_sb"])
        _close(a["h_est"].numpy(), b["h_est"], 1e-4)
    for _ in range(2):
        rt, rj = loop.ul_slot(rng_t), ref.ul_slot(rng_j)
        _same_records(rt, rj)
        n_groups += len({(r["mcs"], r["rank"]) for r in rt})
        assert all(r["crc_ok"] and r["tb_equal"] for r in rt)
    assert loop.rx_calls == n_groups
