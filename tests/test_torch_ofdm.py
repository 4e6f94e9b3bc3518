"""Parity of the port's CP-OFDM modulation/demodulation and DFT entry points
with isac_tpu, on the CPU.

Both sides are float32 FFTs from two libraries (XLA's on the reference side,
pocketfft under torch.fft here): outputs agree to a few ulps of the largest
output, so they are held to 2e-6 of max|.|. Everything around the FFTs (CP
insertion, window extraction, bin mapping) is pure data movement, and the
de-rotation is one complex64 product with the same float64-built phases.

The reference extracts windows by slice/reshape when the span starts on a
half-subframe boundary and by a gather otherwise; the port has one indexed
form, so both an aligned and an unaligned `first_slot` are held against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.config.carrier import ofdm_info as j_ofdm_info
from isac_tpu.ops import dft as j_dft
from isac_tpu.ops import ofdm as j_ofdm
from isac_tpu_torch.config.carrier import ofdm_info as t_ofdm_info
from isac_tpu_torch.ops import dft as t_dft
from isac_tpu_torch.ops import ofdm as t_ofdm

torch.set_num_threads(1)

FFT_TOL = 2e-6  # of max|.|: two float32 FFT libraries


def _cplx(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _close(got, want, tol=FFT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))


# (n_rb, scs_khz, num_slots, first_slot, aligned): SCS 30 puts the long CP on
# the first symbol of every slot (aligned at any first_slot) when
# slots_per_subframe/2 = 1 — so the unaligned cases are SCS 60 from an odd slot
# and SCS 15 (two long-CP symbols inside the one slot, group length 7 | 14).
CASES = [
    (24, 30, 2, 0, True), (51, 30, 4, 0, True), (24, 30, 3, 3, True), (25, 15, 2, 0, True),
    (52, 15, 1, 5, True), (11, 60, 4, 0, True), (11, 60, 2, 1, False), (24, 60, 3, 3, False),
]


@pytest.mark.parametrize("n_rb,scs,num_slots,first_slot,aligned", CASES)
def test_cases_cover_both_window_forms(n_rb, scs, num_slots, first_slot, aligned):
    """The table's `aligned` flag is the reference's own choice of form."""
    info = j_ofdm_info(n_rb, scs)
    assert (j_ofdm._cp_groups(info, num_slots, first_slot) is not None) == aligned


@pytest.mark.parametrize("n_rb,scs,num_slots,first_slot,aligned", CASES)
def test_ofdm_modulate_equal(n_rb, scs, num_slots, first_slot, aligned):
    ji, ti = j_ofdm_info(n_rb, scs), t_ofdm_info(n_rb, scs)
    rng = np.random.default_rng(n_rb * 100 + first_slot)
    grid = _cplx(rng, 3, num_slots * 14, n_rb * 12)
    want = np.asarray(j_ofdm.ofdm_modulate(jnp.asarray(grid), ji, first_slot))
    got = t_ofdm.ofdm_modulate(torch.as_tensor(grid), ti, first_slot).numpy()
    assert got.shape[-1] == int(ti.symbol_lengths_slots(num_slots, first_slot).sum())
    _close(got, want)


@pytest.mark.parametrize("n_rb,scs,num_slots,first_slot,aligned", CASES)
@pytest.mark.parametrize("cp_fraction", [0.55, 1.0])
def test_ofdm_demodulate_equal(n_rb, scs, num_slots, first_slot, aligned, cp_fraction):
    ji, ti = j_ofdm_info(n_rb, scs), t_ofdm_info(n_rb, scs)
    n_sc = n_rb * 12
    total = int(ti.symbol_lengths_slots(num_slots, first_slot).sum())
    rng = np.random.default_rng(n_rb * 100 + first_slot + 1)
    wave = _cplx(rng, 2, total)
    want = np.asarray(j_ofdm.ofdm_demodulate(jnp.asarray(wave), ji, n_sc, num_slots,
                                             first_slot, cp_fraction))
    got = t_ofdm.ofdm_demodulate(torch.as_tensor(wave), ti, n_sc, num_slots, first_slot,
                                 cp_fraction).numpy()
    _close(got, want)


@pytest.mark.parametrize("n_rb,scs,num_slots,first_slot,aligned", CASES)
def test_ofdm_round_trip(n_rb, scs, num_slots, first_slot, aligned):
    """demodulate(modulate(g)) == g, and the round trip equals the reference's."""
    ji, ti = j_ofdm_info(n_rb, scs), t_ofdm_info(n_rb, scs)
    n_sc = n_rb * 12
    rng = np.random.default_rng(n_rb + first_slot)
    grid = _cplx(rng, 2, num_slots * 14, n_sc)
    back = t_ofdm.ofdm_demodulate(
        t_ofdm.ofdm_modulate(torch.as_tensor(grid), ti, first_slot), ti, n_sc, num_slots,
        first_slot).numpy()
    _close(back, grid, tol=2e-6)
    want = np.asarray(j_ofdm.ofdm_demodulate(
        j_ofdm.ofdm_modulate(jnp.asarray(grid), ji, first_slot), ji, n_sc, num_slots,
        first_slot))
    _close(back, want)


def test_ofdm_demodulate_pads_a_short_waveform():
    ji, ti = j_ofdm_info(24, 30), t_ofdm_info(24, 30)
    rng = np.random.default_rng(9)
    wave = _cplx(rng, 2, int(ti.symbol_lengths_slots(2, 0).sum()) - 300)
    want = np.asarray(j_ofdm.ofdm_demodulate(jnp.asarray(wave), ji, 288, 2))
    _close(t_ofdm.ofdm_demodulate(torch.as_tensor(wave), ti, 288, 2).numpy(), want)


def test_ofdm_modulate_rejects_partial_slot():
    with pytest.raises(ValueError):
        t_ofdm.ofdm_modulate(torch.zeros((1, 13, 288), dtype=torch.complex64), t_ofdm_info(24, 30))


def test_bin_mapping_exact():
    rng = np.random.default_rng(2)
    for n_sc, nfft in ((288, 512), (612, 1024), (133, 256)):
        grid = _cplx(rng, 2, 3, n_sc)
        bins_j = np.asarray(j_ofdm._grid_to_bins(jnp.asarray(grid), n_sc, nfft))
        bins_t = t_ofdm._grid_to_bins(torch.as_tensor(grid), n_sc, nfft)
        np.testing.assert_array_equal(bins_t.numpy(), bins_j)
        np.testing.assert_array_equal(t_ofdm._bins_to_grid(bins_t, n_sc, nfft).numpy(), grid)
        np.testing.assert_array_equal(
            np.asarray(j_ofdm._bins_to_grid(jnp.asarray(bins_j), n_sc, nfft)), grid)


@pytest.mark.parametrize("n,axis", [(None, -1), (64, -1), (20, -1), (None, -2), (16, -2), (5, 0)])
def test_fft_auto_n_and_axis(n, axis):
    """`n=` zero-pads or trims to the first n entries, along `axis`, in both."""
    rng = np.random.default_rng(4)
    x = _cplx(rng, 3, 12, 40)
    for name in ("fft_auto", "ifft_auto"):
        want = np.asarray(jax.jit(getattr(j_dft, name), static_argnums=(1, 2))(
            jnp.asarray(x), n, axis))
        got = getattr(t_dft, name)(torch.as_tensor(x), n, axis).numpy()
        _close(got, want)
