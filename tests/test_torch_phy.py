"""Parity of the port's modulation, channel estimation, MMSE, PDSCH transmit
and CDL response with isac_tpu, on the CPU.

Bits and elementwise float chains (modulation, max-log LLRs, descrambling,
DM-RS rows, layer maps) are compared exactly. Outputs that go through a sum
of complex products — the DFT-basis interpolation, the PRG precoding, the
ray contraction — are compared with a stated tolerance: both sides are
float32, but XLA and PyTorch sum those products in different orders, and
each such sum carries a few ulps of the largest term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.ops import channel_est as j_ce
from isac_tpu.ops import modulation as j_mod
from isac_tpu.parallel import links as j_links
from isac_tpu.phy import chains as j_chains
from isac_tpu_torch.ops import channel_est as t_ce
from isac_tpu_torch.ops import modulation as t_mod
from isac_tpu_torch.parallel import links as t_links
from isac_tpu_torch.phy import chains as t_chains
from isac_tpu_torch.example import example_links

torch.set_num_threads(1)

# float32 sums of complex products in a different order: a few ulps (6e-8)
# of the largest term, with headroom for sums of up to ~500 terms
SUM_RTOL = 2e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _cplx(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _close(got, want, rtol=SUM_RTOL):
    """|got - want| <= rtol * max|want| elementwise (a scale-relative bound:
    summation-order error scales with the largest term, not with each
    output's own size)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "16QAM", "64QAM", "256QAM"])
def test_modulate_and_demodulate_equal(mod):
    qm = t_mod.MODULATION_ORDERS[mod]
    rng = np.random.default_rng(qm)
    bits = rng.integers(0, 2, (2, 60 * qm)).astype(np.int8)
    seq = rng.integers(0, 2, 60 * qm).astype(np.uint8)
    sym_j = np.asarray(j_mod.modulate(jnp.asarray(bits), mod, scramble=jnp.asarray(seq)))
    sym_t = t_mod.modulate(_t(bits), mod, scramble=_t(seq)).numpy()
    np.testing.assert_array_equal(sym_t, sym_j)
    np.testing.assert_array_equal(t_mod.constellation(mod), j_mod.constellation(mod))
    if mod != "BPSK":
        for a, b in zip(t_mod._axis_levels(qm), j_mod._axis_levels(qm)):
            np.testing.assert_array_equal(a, b)
    # max-log LLRs: elementwise (x - level)^2, masked mins with 1e30
    # sentinels, one division — the same float32 operations: exact
    y = (sym_j + 0.3 * _cplx(rng, *sym_j.shape)).astype(np.complex64)
    sinr = rng.uniform(0.5, 200.0, sym_j.shape).astype(np.float32)
    nv_j = 1.0 / jnp.maximum(jnp.asarray(sinr), 1e-9)
    nv_t = 1.0 / torch.clamp_min(_t(sinr), 1e-9)
    np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv_j))
    llr_j = np.asarray(j_mod.demodulate_llr(jnp.asarray(y), nv_j, mod))
    llr_t = t_mod.demodulate_llr(_t(y), nv_t, mod).numpy()
    if mod == "BPSK":  # complex |.|^2 of a complex difference: hypot rounding
        np.testing.assert_allclose(llr_t, llr_j, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(llr_t, llr_j)
    np.testing.assert_array_equal(
        t_mod.descramble_llr(_t(llr_j), _t(np.resize(seq, llr_j.shape))).numpy(),
        np.asarray(j_mod.descramble_llr(jnp.asarray(llr_j), np.resize(seq, llr_j.shape))))
    assert t_mod.pdsch_scrambling_cinit(7, 1, 33) == j_mod.pdsch_scrambling_cinit(7, 1, 33)
    assert t_mod.pusch_scrambling_cinit(7, 33) == j_mod.pusch_scrambling_cinit(7, 33)


@pytest.mark.parametrize("ports,dsyms,n_prb,n_basis", [
    ((0,), (2, 11), 5, 6), ((0, 2), (2, 11), 4, 6), ((0, 2, 1), (2, 7, 11), 3, 6),
    ((0, 2), (2,), 3, 3),
])
def test_channel_estimate_equal(ports, dsyms, n_prb, n_basis):
    """H and noise variance from the DM-RS estimator. H goes through the
    DFT-basis interpolation products (SUM_RTOL); nvar is a mean of |.|^2 over
    a few hundred pilots summed in another order (rtol 1e-5)."""
    rng = np.random.default_rng(len(ports) * 10 + n_prb)
    rx = _cplx(rng, 2, 14, 12 * n_prb)
    refs = _cplx(rng, len(dsyms), 6 * n_prb)
    hj, nj = j_ce.estimate_channel_canonical(jnp.asarray(rx), jnp.asarray(refs), ports,
                                             dsyms, n_prb, n_basis=n_basis)
    ht, nt = t_ce.estimate_channel_canonical(_t(rx), _t(refs), ports, dsyms, n_prb,
                                             n_basis=n_basis)
    _close(ht.numpy(), hj)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5)
    # the leading link axis gives the same per-link result
    hb, nb = t_ce.estimate_channel_canonical(_t(np.stack([rx, rx])), _t(np.stack([refs, refs])),
                                             ports, dsyms, n_prb, n_basis=n_basis)
    np.testing.assert_array_equal(hb[1].numpy(), ht.numpy())
    assert nb.shape == (2,)


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4])
def test_mmse_equalize_equal(n_layers):
    """Symbols and SINR of the MMSE equalizer. L<=2 is the plane form in the
    reference's expression order; what remains is complex |.| (hypot) and
    complex-division rounding, L>2 adds small complex matrix products. SINR
    rtol 1e-4: det = a11*a22 - |a12|^2 (and 1 - mu) cancel on ill-conditioned
    random channels and amplify those ulps (2e-5 measured at L=2)."""
    rng = np.random.default_rng(n_layers)
    n_rx = max(2, n_layers)
    rx = _cplx(rng, n_rx, 14, 24)
    h = _cplx(rng, 14, 24, n_rx, n_layers)
    nv = np.float32(0.05)
    sj, qj = j_ce.mmse_equalize(jnp.asarray(rx), jnp.asarray(h), jnp.asarray(nv))
    st, qt = t_ce.mmse_equalize(_t(rx), _t(h), _t(nv))
    _close(st.numpy(), sj, 1e-4 if n_layers > 2 else SUM_RTOL)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-4)


def test_layer_map_dmrs_rows_relayer_equal():
    rng = np.random.default_rng(5)
    d = _cplx(rng, 3, 48)
    np.testing.assert_array_equal(t_chains.layer_map(_t(d), 2).numpy(),
                                  np.asarray(j_chains.layer_map(jnp.asarray(d), 2)))
    refs = _cplx(rng, 2, 6 * 4)
    for ports in ((0,), (0, 2), (0, 2, 1, 3)):
        np.testing.assert_array_equal(
            t_chains._dmrs_rows(_t(refs), ports, 48).numpy(),
            np.asarray(j_chains._dmrs_rows(jnp.asarray(refs), ports, 48)))
    llr = rng.standard_normal(2 * 10 * 6).astype(np.float32)
    np.testing.assert_array_equal(t_chains._relayer_llrs(_t(llr), 2, 6, 10).numpy(),
                                  np.asarray(j_chains._relayer_llrs(jnp.asarray(llr), 2, 6, 10)))
    for args in ((1, 0, 14), (1, 2, 10), (2, 0, 12), (3, 0, 14), (1, 8, 3)):
        assert t_chains.dmrs_symbols_for_duration(*args) == \
            j_chains.dmrs_symbols_for_duration(*args)


@pytest.mark.parametrize("kw", [
    dict(n_prb=4, prb_start=3, n_layers=2, mcs=19, n_sc_grid=120),
    dict(prb_set=(0, 2, 3, 7), n_layers=1, mcs=10, n_sc_grid=120),
    dict(n_prb=4, n_layers=2, mcs=5, n_sc_grid=48, reserved_per_prb=((5, 0), (5, 6))),
])
def test_pdsch_transmit_grid_equal(kw):
    """The port grid of the transmit chain: contiguous placement, the
    non-contiguous (RBG) placement and the reserved-RE (scatter) layout.
    Bits to symbols are exact; the PRG precoding sums n_layers complex
    products per RE (SUM_RTOL)."""
    gj, gt = j_chains.SCHGrant(**kw), t_chains.SCHGrant(**kw)
    lay = t_chains._layout(gt.layout_key())
    rng = np.random.default_rng(7)
    tb = rng.integers(0, 2, (2, lay["tbs"])).astype(np.int8)
    n_prg = (len(gt.prbs) + 1) // 2
    w = _cplx(rng, 2, n_prg, 4, gt.n_layers)
    want = np.stack([np.asarray(j_chains.sch_transmit(jnp.asarray(tb[i]), gj, w=w[i])[0])
                     for i in range(2)])
    seq = _t(t_chains._scrambling_seq(gt, lay["cfg"].g))
    refs = _t(t_chains._dmrs_refs(gt, lay["dsyms"]))
    got = t_chains._make_tx_fn(gt.layout_key())(_t(tb), seq, refs, gt.prbs, gt.rv, _t(w))
    _close(got.numpy(), want)


def test_cdl_frequency_response_equal():
    """H[L, S, K, rx, tx] from the same ray constants: the reference's host
    float64 phases and complex64 contraction over up to 460 rays, the port's
    phases from float64 on the device (within one float32 ulp of the host's)
    and a fold and product per cluster delay, summed in another order
    (SUM_RTOL of max|H|). The port's batch of the links equals the batch it
    makes of the reference's padded arrays."""
    bl_j = j_links.stack_links(example_links(3, seed=5))
    bl_t = t_links.links_from_numpy(bl_j.coeff, bl_j.tau, bl_j.nu, device="cpu")
    t = np.arange(14) * (5e-4 / 14)
    f = (np.arange(48) - 24) * 30e3
    hj = np.asarray(j_links.batched_frequency_response(bl_j, t, f, scale=1579.0))
    ht = t_links.batched_frequency_response(bl_t, t, f, scale=1579.0).numpy()
    _close(ht, hj)
    bl_s = t_links.stack_links(example_links(3, seed=5), device="cpu")
    np.testing.assert_array_equal(bl_s.coeff.numpy(), bl_t.coeff.numpy())
    np.testing.assert_array_equal(bl_s.nu.numpy(), bl_t.nu.numpy())
    np.testing.assert_array_equal(bl_s.delays, bl_t.delays)
    assert (bl_s.n_rays, bl_s.ports) == (bl_t.n_rays, bl_t.ports) == (bl_j.tau.shape[1], (2, 16))
