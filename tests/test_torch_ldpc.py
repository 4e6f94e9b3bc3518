"""Parity of the port's CRC, LDPC, layered decoder and transport chain with
isac_tpu, on the CPU.

All outputs compared here are bits, integers or LLRs that both packages
compute with the same float32 operations in the same order, so every
comparison is exact — the layered decoder's posterior included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.ops import crc as j_crc
from isac_tpu.ops import ldpc as j_ldpc
from isac_tpu.ops import transport as j_transport
from isac_tpu.ops.ldpc_layered import _decode_layered_xla
from isac_tpu.ops.ldpc_layered import decode_layered as j_decode_layered
from isac_tpu_torch.ops import crc as t_crc
from isac_tpu_torch.ops import ldpc as t_ldpc
from isac_tpu_torch.ops import transport as t_transport
from isac_tpu_torch.ops import ldpc_layered as t_layered
from isac_tpu_torch.ops.ldpc_layered import decode_layered as t_decode_layered
from isac_tpu_torch.ops.ldpc_layered import layered_posterior

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _noisy_llr(bg, z, n_cw, sigma, seed):
    code = j_ldpc.lifted_code(bg, z)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (n_cw, code.k)).astype(np.int8)
    cw = np.asarray(j_ldpc.encode(code, jnp.asarray(msg))).astype(np.float32)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sigma**2).astype(np.float32)
    llr[:, : 2 * z] = 0.0  # punctured columns
    return llr


@pytest.mark.parametrize("kind", ["24A", "24B", "16", "11", "6"])
def test_crc_equal(kind):
    rng = np.random.default_rng(1)
    for n in (1, 40, 3000):
        bits = rng.integers(0, 2, (3, n)).astype(np.int8)
        want = np.asarray(j_crc.crc_compute(jnp.asarray(bits), kind))
        got = t_crc.crc_compute(_t(bits), kind).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], j_crc.crc_bitserial_reference(bits[0], kind))
        with_crc = t_crc.crc_attach(_t(bits), kind)
        bad = with_crc.clone()
        bad[1, 0] ^= 1
        np.testing.assert_array_equal(t_crc.crc_check(bad, kind).numpy(),
                                      np.asarray(j_crc.crc_check(jnp.asarray(bad.numpy()), kind)))
        assert t_crc.crc_check(bad, kind).tolist() == [True, False, True]


@pytest.mark.parametrize("bg,z", [(1, 384), (1, 20), (2, 52), (2, 64), (2, 160)])
def test_encode_and_parity_check_equal(bg, z):
    code = j_ldpc.lifted_code(bg, z)
    rng = np.random.default_rng(bg * 100 + z)
    msg = rng.integers(0, 2, (3, code.k)).astype(np.int8)
    cw_j = np.asarray(j_ldpc.encode(code, jnp.asarray(msg)))
    cw_t = t_ldpc.encode(t_ldpc.lifted_code(bg, z), _t(msg)).numpy()
    np.testing.assert_array_equal(cw_t, cw_j)
    bad = cw_j.copy()
    bad[1, 5] ^= 1
    np.testing.assert_array_equal(t_ldpc.parity_check(_t(bad), bg, z).numpy(),
                                  np.asarray(j_ldpc.parity_check(jnp.asarray(bad), bg, z)))
    assert t_ldpc.parity_check(_t(bad), bg, z).tolist() == [True, False, True]


# (bg, z, e_bits, n_filler, qm): fillers, no fillers, and repetition (E > Ncb)
RM_CASES = [(1, 384, 16260, 224, 6), (2, 52, 1200, 0, 2), (2, 160, 5000, 96, 4),
            (2, 20, 3000, 40, 2)]


@pytest.mark.parametrize("bg,z,e_bits,n_filler,qm", RM_CASES)
def test_rate_match_and_recover_equal(bg, z, e_bits, n_filler, qm):
    code = j_ldpc.lifted_code(bg, z)
    k = code.k
    rng = np.random.default_rng(e_bits)
    cw = rng.integers(0, 2, (2, code.n_full)).astype(np.int8)
    cw[:, k - n_filler: k] = 0
    for rv in (0, 2, 3, 1):
        want = np.asarray(j_ldpc.rate_match(jnp.asarray(cw), bg, z, e_bits, rv, n_filler, k, qm))
        got = t_ldpc.rate_match(_t(cw), bg, z, e_bits, rv, n_filler, k, qm).numpy()
        np.testing.assert_array_equal(got, want)
        llr = rng.standard_normal((2, e_bits)).astype(np.float32) * 3
        soft = rng.standard_normal((2, (66 if bg == 1 else 50) * z)).astype(np.float32)
        fj, bj = j_ldpc.rate_recover(jnp.asarray(llr), bg, z, rv, n_filler, k, qm,
                                     soft_buffer=jnp.asarray(soft))
        ft, bt = t_ldpc.rate_recover(_t(llr), bg, z, rv, n_filler, k, qm, soft_buffer=_t(soft))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(t_ldpc._rv_k0_virtual(bg, z, n_filler, k),
                                  j_ldpc._rv_k0_virtual(bg, z, n_filler, k))


@pytest.mark.parametrize("bg,z,n_iter", [(1, 384, 6), (2, 64, 4), (2, 52, 6), (1, 20, 3)])
def test_layered_posterior_equals_reference(bg, z, n_iter):
    """The plain version's posterior is bit-equal to the reference's scan
    decoder (same row order, same float32 operations in the same order)."""
    llr = _noisy_llr(bg, z, 3, 0.85, seed=z)
    n_cols = j_ldpc.lifted_code(bg, z).n_cols
    want = np.asarray(_decode_layered_xla(jnp.asarray(llr.reshape(3, n_cols, z)), bg, z,
                                          n_iter, 0.75))
    got = layered_posterior(_t(llr), bg, z, n_iter, 0.75, impl="torch").numpy()
    np.testing.assert_array_equal(got, want)
    hj, okj = j_decode_layered(jnp.asarray(llr), bg, z, n_iter=n_iter, impl="xla")
    ht, okt = t_decode_layered(_t(llr), bg, z, n_iter=n_iter)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def _pressed_llr(kind, bg, z, seed):
    """[3, n_full] LLRs that press on the compressed message state."""
    code = j_ldpc.lifted_code(bg, z)
    rng = np.random.default_rng(seed)
    shape = (3, code.n_cols, z)
    if kind == "zeros":
        llr = np.zeros(shape, np.float32)
        llr[1] = -0.0
    elif kind in ("ties", "negzeros"):
        # a few levels only, so several edges of a row share the minimum
        llr = (rng.integers(1, 4, shape) * rng.choice([-0.5, 0.5], shape)).astype(np.float32)
        if kind == "negzeros":
            llr[rng.random(shape) < 0.2] = -0.0
            llr[rng.random(shape) < 0.1] = 0.0
    elif kind == "deg19_last":
        # row 0 has degree 19: its last edge gets the smallest magnitude in
        # every lane, and a negative sign (the top sign bit of the packed word)
        llr = (rng.uniform(2.0, 6.0, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
        _, plan = t_layered._row_plan(bg, z)
        assert len(plan[0]) == 19
        llr[:, plan[0][-1][1]] = -rng.uniform(0.1, 0.5, (3, z)).astype(np.float32)
    else:
        raise ValueError(kind)
    return llr.reshape(3, code.n_full)


def _row0_mags(llr, bg, z):
    """|t| of row 0 in the first sweep, [3, deg, z]: t is the LLR itself there."""
    _, plan = t_layered._row_plan(bg, z)
    lv = llr.reshape(3, -1, z)
    i = np.arange(z)
    return np.abs(np.stack([lv[:, c][:, (i + s) % z] for _, c, s in plan[0]], axis=1))


def _assert_posterior_bits_equal(llr, bg, z, n_iter):
    """Bit patterns, so that -0.0 and +0.0 count as different."""
    n_cols = j_ldpc.lifted_code(bg, z).n_cols
    want = np.asarray(_decode_layered_xla(jnp.asarray(llr.reshape(3, n_cols, z)), bg, z,
                                          n_iter, 0.75))
    got = layered_posterior(_t(llr), bg, z, n_iter, 0.75, impl="torch").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# the (bg, z, n_iter) triples are those of test_layered_posterior_equals_reference
# at its batch of 3, so the reference compiles nothing new here
@pytest.mark.parametrize("kind,bg,z,n_iter", [
    ("ties", 1, 384, 6), ("ties", 2, 64, 4), ("ties", 2, 52, 6), ("ties", 1, 20, 3),
    ("zeros", 2, 52, 6), ("negzeros", 2, 64, 4), ("negzeros", 1, 20, 3),
    ("deg19_last", 1, 384, 6), ("deg19_last", 1, 20, 3),
])
def test_layered_posterior_pressed_cases_equal_reference(kind, bg, z, n_iter):
    """Inputs that the compressed message state could get wrong: ties for the
    minimum (min2 then equals min1, so every edge must get the same magnitude
    whichever tied index is kept), zeros of both signs, and the minimum at the
    last edge of a degree-19 row with its sign bit set."""
    llr = _pressed_llr(kind, bg, z, seed=z + n_iter)
    mags = _row0_mags(llr, bg, z)
    if kind == "ties":
        assert ((mags == mags.min(axis=1, keepdims=True)).sum(axis=1) > 1).any()
    if kind == "deg19_last":
        assert (mags.argmin(axis=1) == 18).all()
        assert (mags[:, 18:] < np.delete(mags, 18, axis=1).min(axis=1, keepdims=True)).all()
    _assert_posterior_bits_equal(llr, bg, z, n_iter)


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("kind", ["noisy", "ties", "negzeros"])
def test_layered_first_sweeps_equal_reference(kind, n_iter):
    """n_iter=1 is only the sweep that reads no message; n_iter=2 adds the
    first sweep that rebuilds them from the compressed state. After one sweep
    the signs of zeros are still in the posterior (later sweeps wash them
    out), so "negzeros" here is what tells -0.0 from +0.0 in the first sweep."""
    bg, z = 2, 52
    llr = _noisy_llr(bg, z, 3, 0.85, seed=7) if kind == "noisy" else _pressed_llr(kind, bg, z, 7)
    _assert_posterior_bits_equal(llr, bg, z, n_iter)


def test_layered_zero_sweeps_returns_a_copy():
    llr = _t(_noisy_llr(2, 52, 3, 0.85, seed=7))
    got = layered_posterior(llr, 2, 52, 0, impl="torch")
    assert got.data_ptr() != llr.data_ptr()
    np.testing.assert_array_equal(got.numpy().reshape(3, -1), llr.numpy())


@pytest.mark.parametrize("deg", range(3, 20))
def test_packed_state_round_trips(deg):
    """The packed word gives back the minimum's index and every sign bit, for
    every row degree of the two base graphs (3..19)."""
    rng = np.random.default_rng(deg)
    neg = rng.random((2, deg, 9)) < 0.5
    arg = rng.integers(0, deg, (2, 1, 9))
    neg[0, :, 0], neg[0, :, 1], neg[0, :, 2] = True, False, False
    neg[0, deg - 1, 2] = True  # only the top sign bit
    arg[0, 0, :3] = deg - 1
    word = t_layered._pack_state(_t(arg), _t(neg))
    assert word.dtype == torch.int32 and word.shape == (2, 9)
    assert int(word[0, 2]) == (1 << (deg - 1)) | ((deg - 1) << 19)
    arg2, neg2 = t_layered._unpack_state(word, deg)
    np.testing.assert_array_equal(arg2.numpy(), arg)
    np.testing.assert_array_equal(neg2.numpy(), neg)


def test_packed_state_refuses_a_wider_row():
    with pytest.raises(ValueError, match="packed word"):
        t_layered._pack_state(torch.zeros(1, 1, 4, dtype=torch.int64),
                              torch.zeros(1, 20, 4, dtype=torch.bool))


@pytest.mark.parametrize("bg,z", [(1, 384), (2, 52)])
def test_csr_plan_matches_row_plan(bg, z):
    """The kernel's tables: row pointers, and per edge in row order the byte
    offset of (col, shift) and the first lane that wraps; the largest degree
    fits the packed word."""
    code, plan = t_layered._row_plan(bg, z)
    row_ptr, edges, max_deg = t_layered._csr_plan(bg, z, torch.device("cpu"))
    assert row_ptr.dtype == edges.dtype == torch.int32 and edges.is_contiguous()
    assert row_ptr.tolist() == np.cumsum([0] + [len(r) for r in plan]).tolist()
    assert edges.tolist() == [[(c * z + s) * 4, z - s] for r in plan for _, c, s in r]
    assert max_deg == max(len(r) for r in plan) <= t_layered._SIGN_BITS
    assert 0 <= int(edges[:, 0].min()) and int(edges[:, 0].max()) < code.n_cols * z * 4
    assert 1 <= int(edges[:, 1].min()) and int(edges[:, 1].max()) <= z


def test_kernel_launch_shape():
    """Codewords per CTA and shared memory, as the wrapper hands them to the
    kernel: one codeword per CTA until the batch outgrows the SMs, then as
    many as the thread and shared-memory limits of two CTAs per SM allow."""
    shape = t_layered._cw_per_cta
    bg1 = (46, 68, 316)
    assert shape(116, *bg1, 384, 132) == 1 and shape(300, *bg1, 384, 132) == 1
    assert t_layered._smem_bytes(*bg1, 384, 1) == 2720 + 68 * 384 * 4  # tables 2716 -> 2720
    assert t_layered._smem_bytes(*bg1, 384, 1) <= t_layered._SMEM_TWO_PER_SM
    assert shape(8, 42, 52, 197, 52, 132) == 1
    assert shape(1000, *bg1, 64, 132) == 6  # 6 * 64 = 384 threads
    assert shape(1000, *bg1, 2, 132) == 8  # ceil(1000 / 132)
    assert shape(100000, *bg1, 2, 132) == 192
    for b, z in ((1000, 64), (100000, 2), (5000, 20)):
        n = shape(b, *bg1, z, 132)
        assert n * z <= t_layered._MAX_THREADS
        assert t_layered._smem_bytes(*bg1, z, n) <= t_layered._SMEM_TWO_PER_SM


def test_layered_decoder_equals_pallas_interpret():
    """Hard bits and parity flags equal the TPU kernel's (run in interpret
    mode), on BG2 Z=64 with punctured columns, as tests/test_ldpc.py holds
    the two reference implementations together."""
    bg, z = 2, 64
    llr = _noisy_llr(bg, z, 4, 0.8, seed=3)
    hp, okp = j_decode_layered(jnp.asarray(llr), bg, z, n_iter=2, impl="pallas")
    ht, okt = t_decode_layered(_t(llr), bg, z, n_iter=2, impl="torch")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hp))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okp))


def test_cuda_impl_on_cpu_tensor_raises():
    llr = torch.zeros(1, t_ldpc.lifted_code(2, 64).n_full)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_decode_layered(llr, 2, 64, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        t_decode_layered(llr, 2, 64, impl="pallas")


def test_sch_encode_decode_harq_equal():
    """TB, CRC flag and soft buffers through sch_encode/sch_decode with C>1
    segmentation, over a HARQ sequence RV 0 -> 2 whose first transmission is
    too noisy to decode alone."""
    a, rate, qm, n_layers = 12000, 0.6, 4, 1
    cfg_j = j_transport.sch_config(a, rate, qm, n_layers, 20164)
    cfg_t = t_transport.sch_config(a, rate, qm, n_layers, 20164)
    assert cfg_t.c > 1 and len(t_transport._cb_groups(cfg_t)) == 2
    rng = np.random.default_rng(11)
    tb = rng.integers(0, 2, (2, a)).astype(np.int8)
    bufs_j = bufs_t = None
    oks = []
    for rv, sigma in ((0, 0.95), (2, 0.95)):
        enc_j = np.asarray(j_transport.sch_encode(jnp.asarray(tb), cfg_j, rv))
        enc_t = t_transport.sch_encode(_t(tb), cfg_t, rv).numpy()
        np.testing.assert_array_equal(enc_t, enc_j)
        y = (1.0 - 2.0 * enc_j) + sigma * rng.standard_normal(enc_j.shape)
        llr = (2.0 * y / sigma**2).astype(np.float32)
        out_j = [j_transport.sch_decode(jnp.asarray(llr[i]), cfg_j, rv,
                                        None if bufs_j is None else bufs_j[i])
                 for i in range(2)]
        tb_t, ok_t, bufs_t = t_transport.sch_decode(_t(llr), cfg_t, rv,
                                                    None if bufs_t is None else bufs_t)
        for i in range(2):
            np.testing.assert_array_equal(tb_t[i].numpy(), np.asarray(out_j[i][0]))
            assert bool(ok_t[i]) == bool(out_j[i][1])
            np.testing.assert_array_equal(bufs_t[i].numpy(), np.asarray(out_j[i][2]))
        bufs_j = [o[2] for o in out_j]
        oks.append(ok_t.tolist())
    assert oks[0] != [True, True] and oks[1] == [True, True], oks
    np.testing.assert_array_equal(tb_t.numpy(), tb)
