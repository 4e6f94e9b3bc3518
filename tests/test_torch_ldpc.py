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
