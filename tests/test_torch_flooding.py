"""Parity of the port's flooding LDPC decoder and of sch_decode's three
schedules with isac_tpu, on the CPU.

Hard bits and parity flags are compared exactly on the seeded cases. The
decoder's column aggregation is a one-hot float32 matrix product on both
sides, summed in another order by PyTorch than by XLA, so the posterior
totals move by ulps; a hard bit can only flip where a total sits within
those ulps of zero. A codeword that converges never does; one that fails keeps
totals near zero for all its iterations and may (seed 5 of the sch_decode case
below flips 1 bit of 9000 in the failing grant), so the seeds here are ones
where the failing codewords agree too.

The early exit is checked for what it decides on: one stop for the batch of
a plain decode() call, one stop per rate-match run and per grant inside
sch_decode (never one merged decision), with the iteration counts held
against counts derived from the reference decoder run without early exit.
The layered schedule runs through the reference's Pallas kernel as the
reference's own tests run it on the CPU (interpret mode is its CPU default).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.ops import ldpc as j_ldpc
from isac_tpu.ops import transport as j_transport
from isac_tpu_torch.ops import ldpc as t_ldpc
from isac_tpu_torch.ops import transport as t_transport

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _noisy_codewords(bg, z, shape, sigma, seed, bad=()):
    """Seeded codewords through BPSK + AWGN -> (msg, llr [*shape, n_full]);
    the codewords listed in `bad` get sigma 3x (they fail to decode)."""
    code = t_ldpc.lifted_code(bg, z)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (*shape, code.k)).astype(np.int8)
    cw = t_ldpc.encode(code, _t(msg)).numpy().astype(np.float64)
    sig = np.full(shape, sigma)
    for i in bad:
        sig[i] = 3.0 * sigma
    y = (1.0 - 2.0 * cw) + sig[..., None] * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sig[..., None] ** 2).astype(np.float32)
    llr[..., : 2 * z] = 0.0  # the punctured columns
    return msg, llr


def _ref_iters(llr, bg, z, n_iter):
    """Iterations after which every codeword of llr's batch checks, by the
    reference decoder without early exit (n_iter if never)."""
    for it in range(1, n_iter + 1):
        _, ok = j_ldpc.decode(jnp.asarray(llr), bg, z, n_iter=it, early_exit=False)
        if bool(np.all(np.asarray(ok))):
            return it
    return n_iter


@pytest.mark.parametrize("bg,z,sigma", [(1, 8, 0.6), (2, 12, 0.75), (2, 36, 0.8)])
@pytest.mark.parametrize("early_exit", [False, True])
def test_flooding_decode_equal(bg, z, sigma, early_exit):
    """Hard bits and parity flags, with a failing codeword in the batch."""
    msg, llr = _noisy_codewords(bg, z, (5,), sigma, seed=bg * 100 + z, bad=(3,))
    hj, okj = j_ldpc.decode(jnp.asarray(llr), bg, z, n_iter=10, early_exit=early_exit)
    ht, okt = t_ldpc.decode(_t(llr), bg, z, n_iter=10, early_exit=early_exit)
    assert ht.dtype == torch.int8 and okt.dtype == torch.bool
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert not ok[3] and ok.sum() >= 3  # the bad one fails, most others decode
    np.testing.assert_array_equal(ht.numpy()[ok], msg[ok])


@pytest.mark.parametrize("bg,z", [(1, 8), (2, 12)])
def test_flooding_early_exit_stops_with_the_batch(bg, z):
    """A clean batch stops early, at the iteration the reference's last
    codeword checks; totals and bits are those of that many iterations."""
    msg, llr = _noisy_codewords(bg, z, (2, 3), 0.55, seed=7 + bg)
    want_it = _ref_iters(llr, bg, z, 12)
    assert want_it < 12
    hard, ok, iters = t_ldpc._decode_flooding(_t(llr), bg, z, 12, 0.75, True)
    assert int(iters) == want_it and bool(ok.all())
    hj, _ = j_ldpc.decode(jnp.asarray(llr), bg, z, n_iter=12, early_exit=True)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(hard.numpy(), msg)


def test_flooding_per_group_stop_counts():
    """exit_dims=1: every leading index stops on its own codewords. A group
    that holds a failing codeword runs the whole budget; the others stop
    where the reference stops when it decodes them alone."""
    bg, z, n_iter = 2, 12, 10
    msg, llr = _noisy_codewords(bg, z, (4, 3), 0.6, seed=3, bad=((2, 1),))
    hard, ok, iters = t_ldpc._decode_flooding(_t(llr), bg, z, n_iter, 0.75, True, exit_dims=1)
    want = [_ref_iters(llr[g], bg, z, n_iter) for g in range(4)]
    assert iters.tolist() == want
    assert want[2] == n_iter and max(want[:2] + want[3:]) < n_iter
    for g in range(4):  # each group equals the reference decoding it alone
        hj, okj = j_ldpc.decode(jnp.asarray(llr[g]), bg, z, n_iter=n_iter, early_exit=True)
        np.testing.assert_array_equal(hard[g].numpy(), np.asarray(hj))
        np.testing.assert_array_equal(ok[g].numpy(), np.asarray(okj))
    # one merged decision would run every group to the failing one's budget
    _, _, merged = t_ldpc._decode_flooding(_t(llr), bg, z, n_iter, 0.75, True)
    assert int(merged) == n_iter


def _sch_case(a, rate, qm, g, seed, sigma, n_grants, bad_grant=None):
    cfg_j = j_transport.sch_config(a, rate, qm, 1, g)
    cfg_t = t_transport.sch_config(a, rate, qm, 1, g)
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, (n_grants, a)).astype(np.int8)
    enc = t_transport.sch_encode(_t(tb), cfg_t, 0).numpy().astype(np.float64)
    sig = np.full(n_grants, sigma)
    if bad_grant is not None:
        sig[bad_grant] = 2.5 * sigma
    y = (1.0 - 2.0 * enc) + sig[:, None] * rng.standard_normal(enc.shape)
    llr = (2.0 * y / sig[:, None] ** 2).astype(np.float32)
    return cfg_j, cfg_t, tb, llr


@pytest.mark.parametrize("schedule", ["auto", "layered", "flooding"])
def test_sch_decode_schedules_equal(schedule):
    """TB bits, CRC flags and soft buffers in all three schedules, C > 1 with
    two rate-match runs, three grants of which one fails."""
    cfg_j, cfg_t, tb, llr = _sch_case(9000, 0.55, 2, 16362, 6, 0.6, 3, bad_grant=1)
    assert cfg_t.c > 1 and len(t_transport._cb_groups(cfg_t)) == 2
    n_iter = 12 if schedule == "flooding" else 6
    tb_t, ok_t, bufs_t = t_transport.sch_decode(_t(llr), cfg_t, 0, None, n_iter=n_iter,
                                                schedule=schedule)
    for i in range(3):
        tb_j, ok_j, bufs_j = j_transport.sch_decode(jnp.asarray(llr[i]), cfg_j, 0, None,
                                                    n_iter=n_iter, schedule=schedule)
        np.testing.assert_array_equal(tb_t[i].numpy(), np.asarray(tb_j))
        assert bool(ok_t[i]) == bool(ok_j)
        np.testing.assert_array_equal(bufs_t[i].numpy(), np.asarray(bufs_j))
    assert ok_t.tolist() == [True, False, True]
    np.testing.assert_array_equal(tb_t.numpy()[[0, 2]], tb[[0, 2]])
    with pytest.raises(ValueError):
        t_transport.sch_decode(_t(llr), cfg_t, 0, schedule="serial")


def test_sch_decode_flooding_stops_per_run_and_per_grant(monkeypatch):
    """Inside sch_decode the flooding decoder is called once per rate-match
    run, and every grant keeps its own stop: the counts it reports equal the
    reference decoder's on that run of that grant alone."""
    cfg_j, cfg_t, tb, llr = _sch_case(9000, 0.55, 2, 16362, 9, 0.58, 3, bad_grant=2)
    groups = t_transport._cb_groups(cfg_t)
    seen = []
    real = t_ldpc._decode_flooding

    def spy(full, bg, z, n_iter, norm, early_exit, exit_dims=None):
        out = real(full, bg, z, n_iter, norm, early_exit, exit_dims)
        seen.append((tuple(full.shape), early_exit, exit_dims, out[2].tolist(), full.numpy()))
        return out

    monkeypatch.setattr(t_ldpc, "_decode_flooding", spy)
    _, ok_t, _ = t_transport.sch_decode(_t(llr), cfg_t, 0, None, n_iter=10, schedule="flooding")
    assert len(seen) == len(groups) == 2
    for (shape, early, ed, iters, full), (_, cnt, _) in zip(seen, groups):
        assert shape[:2] == (3, cnt) and early and ed == 1
        want = [_ref_iters(full[g], cfg_t.bg, cfg_t.z, 10) for g in range(3)]
        assert iters == want
    assert ok_t.tolist() == [True, True, False]
    # the failing grant ran the budget in some run; a clean grant did not
    assert max(s[3][2] for s in seen) == 10 and max(s[3][0] for s in seen) < 10


def test_rate_match_per_item_rv_equal():
    """rate_match / rate_recover with one rv per item against the reference
    at each rv (bits and float sums exact), BG1 and BG2 with fillers."""
    for bg, z, e_bits, n_filler, qm in ((1, 8, 600, 24, 4), (2, 12, 700, 16, 2), (2, 12, 240, 0, 6)):
        k = (22 if bg == 1 else 10) * z
        n_full = (68 if bg == 1 else 52) * z
        code_n = n_full - 2 * z
        rng = np.random.default_rng(bg + z)
        cw = rng.integers(0, 2, (4, 2, n_full)).astype(np.int8)
        llr = rng.standard_normal((4, 2, e_bits)).astype(np.float32)
        soft = rng.standard_normal((4, 2, code_n)).astype(np.float32)
        rv = np.array([0, 3, 2, 1])
        got = t_ldpc.rate_match(_t(cw), bg, z, e_bits, _t(rv)[:, None], n_filler, k, qm).numpy()
        ft, bt = t_ldpc.rate_recover(_t(llr), bg, z, _t(rv)[:, None], n_filler, k, qm,
                                     soft_buffer=_t(soft))
        for i, r in enumerate(rv):
            want = np.asarray(j_ldpc.rate_match(jnp.asarray(cw[i]), bg, z, e_bits, int(r),
                                                n_filler, k, qm))
            np.testing.assert_array_equal(got[i], want)
            fj, bj = j_ldpc.rate_recover(jnp.asarray(llr[i]), bg, z, int(r), n_filler, k, qm,
                                         soft_buffer=jnp.asarray(soft[i]))
            np.testing.assert_array_equal(ft[i].numpy(), np.asarray(fj))
            np.testing.assert_array_equal(bt[i].numpy(), np.asarray(bj))
        np.testing.assert_array_equal(
            t_ldpc.rate_match_indices_all_rv(bg, z, e_bits, n_filler, k),
            j_ldpc.rate_match_indices_all_rv(bg, z, e_bits, n_filler, k))
        np.testing.assert_array_equal(t_ldpc.interleave_indices(e_bits, qm),
                                      j_ldpc.interleave_indices(e_bits, qm))


def test_sch_encode_decode_mixed_rv_equal():
    """One batch that mixes a new transmission (rv 0) and repeats (rv 3, 2)
    with per-grant soft buffers: encoded bits, TB, CRC and buffers equal the
    reference's grant by grant."""
    cfg_j, cfg_t, tb, _ = _sch_case(5000, 0.5, 4, 10400, 13, 0.9, 3)
    rng = np.random.default_rng(2)
    rv = np.array([0, 3, 2])
    enc_t = t_transport.sch_encode(_t(tb), cfg_t, _t(rv)).numpy()
    code_n = (66 if cfg_t.bg == 1 else 50) * cfg_t.z
    soft = (0.5 * rng.standard_normal((3, cfg_t.c, code_n))).astype(np.float32)
    soft[0] = 0.0
    y = (1.0 - 2.0 * enc_t.astype(np.float64)) + 0.9 * rng.standard_normal(enc_t.shape)
    llr = (2.0 * y / 0.81).astype(np.float32)
    tb_t, ok_t, bufs_t = t_transport.sch_decode(_t(llr), cfg_t, _t(rv), _t(soft))
    for i, r in enumerate(rv):
        enc_j = np.asarray(j_transport.sch_encode(jnp.asarray(tb[i]), cfg_j, int(r)))
        np.testing.assert_array_equal(enc_t[i], enc_j)
        tb_j, ok_j, bufs_j = j_transport.sch_decode(jnp.asarray(llr[i]), cfg_j, int(r),
                                                    jnp.asarray(soft[i]))
        np.testing.assert_array_equal(tb_t[i].numpy(), np.asarray(tb_j))
        assert bool(ok_t[i]) == bool(ok_j)
        np.testing.assert_array_equal(bufs_t[i].numpy(), np.asarray(bufs_j))
    assert t_transport.RV_SEQUENCE == j_transport.RV_SEQUENCE == (0, 3, 2, 1)
