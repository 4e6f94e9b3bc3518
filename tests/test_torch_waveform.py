"""Parity of the port's waveform-domain reception path (phy/waveform_rx.py)
with isac_tpu, on the CPU: overlap-add with clipping and the linear
resampler (elementwise: exact or 1 ulp), the DM-RS reference waveform (an
IFFT: a float32 tolerance), and waveform_receive end to end (timing offset,
an integer: equal; CRC flag and TB bits equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.config.carrier import CarrierConfig as J_Carrier
from isac_tpu.ops import ofdm as j_ofdm
from isac_tpu.phy import chains as j_chains
from isac_tpu.phy import waveform_rx as j_wf
from isac_tpu_torch.config.carrier import CarrierConfig as T_Carrier
from isac_tpu_torch.ops import ofdm as t_ofdm
from isac_tpu_torch.phy import chains as t_chains
from isac_tpu_torch.phy import waveform_rx as t_wf

torch.set_num_threads(1)

# a 256-point float32 IFFT in another library: a few ulps of the largest sample
FFT_RTOL = 2e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _cplx(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _setup(n_prb=8, mcs=8):
    kw = dict(fc_hz=3.5e9, bandwidth_hz=10e6, scs_khz=30, n_cell_id=1, n_rb_override=n_prb,
              nfft_override=256)
    gk = dict(n_prb=n_prb, n_sc_grid=n_prb * 12, mcs=mcs, n_layers=1)
    gj, gt = j_chains.SCHGrant(**gk), t_chains.SCHGrant(**gk)
    tb = np.random.default_rng(5).integers(0, 2, t_chains.grant_tbs(gt)).astype(np.int8)
    return J_Carrier(**kw).ofdm, T_Carrier(**kw).ofdm, gj, gt, tb


def test_overlap_add_equal():
    rng = np.random.default_rng(0)
    waves = [_cplx(rng, 2, n) for n in (16, 8, 16, 16)]
    offs = [0, 8, 24, -8]  # overlap, a tail past the end, a clipped head
    want = np.asarray(j_wf.overlap_add([jnp.asarray(w) for w in waves], offs, 32))
    got = t_wf.overlap_add([_t(w) for w in waves], offs, 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[:, 16:24] == 0) and np.allclose(got[:, 24:], waves[2][:, :8])


@pytest.mark.parametrize("in_rate,out_rate", [(1.0, 2.0), (30.72e6, 61.44e6), (3.0, 2.0)])
def test_resample_linear_equal(in_rate, out_rate):
    tone = np.exp(2j * np.pi * 3 * np.arange(64) / 64.0).astype(np.complex64)
    want = np.asarray(j_wf.resample_linear(jnp.asarray(tone), in_rate, out_rate))
    got = t_wf.resample_linear(_t(tone), in_rate, out_rate).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("delay,signal", [(37, True), (0, True), (0, False)])
def test_waveform_receive_equal(delay, signal):
    """An unknown integer delay is recovered and the aligned waveform decodes;
    a noise-only buffer fails the 5.5x rule and gives offset 0."""
    info_j, info_t, gj, gt, tb = _setup()
    pg, _ = t_chains.sch_transmit(_t(tb), gt)
    ref_j = np.asarray(j_wf.reference_waveform(gj, info_j))
    ref_t = t_wf.reference_waveform(gt, info_t, device="cpu")
    np.testing.assert_allclose(ref_t.numpy(), ref_j, rtol=0,
                               atol=FFT_RTOL * np.abs(ref_j).max())
    wave = t_ofdm.ofdm_modulate(pg, info_t)
    np.testing.assert_allclose(wave.numpy(), np.asarray(j_ofdm.ofdm_modulate(jnp.asarray(pg.numpy()), info_j)),
                               rtol=0, atol=FFT_RTOL * float(wave.abs().max()))
    n_total = wave.shape[-1] + 128
    rng = np.random.default_rng(9)
    if signal:
        rx = t_wf.overlap_add([wave], [delay], n_total).numpy() + _cplx(rng, 1, n_total) * np.float32(1e-3)
    else:
        rx = _cplx(rng, 1, n_total) * np.float32(0.1)
    out_j = j_wf.waveform_receive(jnp.asarray(rx), gj, info_j, jnp.asarray(ref_j), max_offset=128)
    out_t = t_wf.waveform_receive(_t(rx), gt, info_t, ref_t, max_offset=128)
    assert int(out_t["timing_offset"]) == int(out_j["timing_offset"]) == delay
    assert bool(out_t["crc_ok"]) == bool(out_j["crc_ok"]) == signal
    if signal:
        np.testing.assert_array_equal(out_t["tb"].numpy(), np.asarray(out_j["tb"]))
        np.testing.assert_array_equal(out_t["tb"].numpy(), tb)
