"""Parity of the port's mono-static sensing chain with isac_tpu, on the CPU:
radar parameters, echo channel, range-Doppler map, CA-CFAR, DoA estimators,
metrics, and the chain as a whole (sim/sensing.py:make_sensing_chain against
the reference's composition of the same calls).

Tolerances, and why each is what it is:
- host float64 math (radar parameters, steering vectors, echo constants,
  metrics): rtol 1e-12 — the same numpy calls on both sides;
- echo and range-Doppler map: 2e-5 of max|.| — float32 matrix products and two
  FFT libraries, plus cos/sin of a float32 phase that two math libraries round
  differently by an ulp;
- DoA spectra: beamscan (a plain quadratic form) 2e-6 of its maximum (4e-7
  measured; its nulls are differences of the large terms). MUSIC and MVDR
  spectra are INVERSES of float32 quantities that cancel at a source's angle
  (the MUSIC denominator ||Un^H a||^2 falls from ~n_ants to ~1e-7 there; the
  covariances have condition numbers of ~1e5, and an inverse carries
  cond * eps = 6e-3): rtol 5e-3 on the spectra (2.5e-3 measured at one peak
  cell, <= 2.5e-4 elsewhere), and the MUSIC denominators themselves within
  2e-6 of their largest value (6e-7 measured);
- everything discrete (CFAR detection maps, valid masks, range/Doppler bins,
  angles from the scan grid, signal counts): equal. Indices are compared only
  where `valid` holds: the others belong to -inf entries of a top-k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu import config as j_cfg
from isac_tpu.ops import ofdm as j_ofdm
from isac_tpu.ops import sensing as j_sen
from isac_tpu.ops.sensing import cfar as j_cfar
from isac_tpu.ops.sensing import doa as j_doa
from isac_tpu.ops.sensing import echo as j_echo
from isac_tpu.ops.sensing import metrics as j_metrics
from isac_tpu_torch import config as t_cfg
from isac_tpu_torch.ops import sensing as t_sen
from isac_tpu_torch.ops.sensing import cfar as t_cfar
from isac_tpu_torch.ops.sensing import doa as t_doa
from isac_tpu_torch.ops.sensing import echo as t_echo
from isac_tpu_torch.ops.sensing import metrics as t_metrics
from isac_tpu_torch.sim.sensing import make_sensing_chain

torch.set_num_threads(1)

HOST_RTOL = 1e-12
WAVE_TOL = 2e-5  # of max|.|
SPEC_RTOL = 5e-3  # MUSIC, MVDR: inverses of cancelling float32 quantities
BEAMSCAN_TOL = 2e-6  # of max
MUSIC_DENOM_TOL = 2e-6  # of the largest denominator

TARGETS_1 = (((120.0, 40.0, 1.5),), (1.0,), (7.0,))
TARGETS_3 = (((120.0, 40.0, 1.5), (60.0, -45.0, 10.0), (200.0, 150.0, 1.5)),
             (1.0, 4.0, 10.0), (7.0, -12.0, 3.0))
# two echoes of about equal power, more than a Doppler bin apart at 10 slots
TARGETS_2 = (((120.0, 40.0, 1.5), (70.0, -60.0, 1.5)), (3.3, 1.0), (20.0, -25.0))
ANTENNAS = {
    "ula8x2": ("ULA", dict(n_v=8, polarizations=2)),
    "ula4": ("ULA", dict(n_v=4, polarizations=1)),
    "upa2x4": ("UPA", dict(n_v=2, n_h=4, polarizations=1)),
    "upa2x2x2": ("UPA", dict(n_v=2, n_h=2, polarizations=2)),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _cplx(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _close(got, want, tol=WAVE_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))


def _setup(antenna="ula8x2", targets=TARGETS_1, num_slots=4, bw=10e6, only=None):
    """The same small cell in both packages: (gnb, carrier, params) x2 (or of
    package `only` alone). 10 MHz at SCS 30 kHz is 24 PRB (288 subcarriers,
    nfft 512)."""
    out = []
    pkgs = ((j_cfg, j_sen), (t_cfg, t_sen))
    for cfg, sen in pkgs if only is None else pkgs[only: only + 1]:
        kind, kw = ANTENNAS[antenna]
        gnb = cfg.GNBParams(dl_bandwidth=bw, ul_bandwidth=bw, scs_khz=30,
                            antenna=getattr(cfg, kind)(**kw))
        pos, rcs, vel = (np.asarray(x, np.float64) for x in targets)
        out.append((gnb, gnb.carrier,
                    sen.derive_radar_params(gnb, gnb.carrier, pos, rcs, vel, num_slots)))
    return out


def _qpsk_grid(rng, gnb, n_sym, n_sc):
    """bench-style +-1 +-1j grid with the reference amplitude law."""
    info = gnb.carrier.ofdm
    n_tx = gnb.num_tx_ants
    grid = ((rng.integers(0, 2, (n_tx, n_sym, n_sc)) * 2 - 1)
            + 1j * (rng.integers(0, 2, (n_tx, n_sym, n_sc)) * 2 - 1)) / np.sqrt(2)
    amp = 10 ** ((gnb.tx_power_dbm - 30) / 20) * np.sqrt(info.nfft**2 / (n_sc * n_tx))
    return (grid * amp).astype(np.complex64)


# ------------------------------------------------------------------ radar params


@pytest.mark.parametrize("antenna", list(ANTENNAS))
@pytest.mark.parametrize("targets", [TARGETS_1, TARGETS_3], ids=["1tgt", "3tgt"])
def test_radar_params_equal(antenna, targets):
    if antenna.startswith("upa") and len(targets[1]) > 1:
        # the reference's UPA steering vector broadcasts for ONE angle only
        # (x [n_v, 1] against angles [1, 1, T]); the port keeps that behaviour
        for setup_pkg in (0, 1):
            with pytest.raises(ValueError, match="broadcast"):
                _setup(antenna, targets, num_slots=5, only=setup_pkg)
        return
    (_, _, pj), (_, _, pt) = _setup(antenna, targets, num_slots=5)
    for name in ("fc", "fs", "tsri", "n0", "tx_power_dbm", "pfa", "r_res", "r_max", "v_res",
                 "v_max", "range_m", "velocity_ms", "azimuth_deg", "elevation_deg",
                 "large_scale_fading", "snr_db", "steering"):
        np.testing.assert_allclose(getattr(pt, name), getattr(pj, name), rtol=HOST_RTOL, atol=0,
                                   err_msg=name)
    for name in ("n_tx_ants", "n_targets", "n_ifft", "n_fft", "cfar_zone", "azimuth_scan",
                 "elevation_scan"):
        assert getattr(pt, name) == getattr(pj, name), name
    assert type(pt.antenna).__name__ == type(pj.antenna).__name__
    assert len(pt.truth) == len(pj.truth)
    for a, b in zip(pt.truth, pj.truth):
        assert a.keys() == b.keys() and a["ID"] == b["ID"]
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=HOST_RTOL, abs=0), k


def test_radar_params_doppler_fft_counts_dl_symbols_only():
    """DDDSU over 5 slots: 3/5 * 5 * 14 = 42 DL symbols -> n_fft 64, fewer than
    the 70 symbols of the grid (the range-Doppler map trims)."""
    (_, _, pj), (_, _, pt) = _setup(num_slots=5)
    assert pt.n_fft == pj.n_fft == 64 and pt.n_ifft == pj.n_ifft == 512


@pytest.mark.parametrize("antenna", list(ANTENNAS))
def test_steering_vector_equal(antenna):
    kind, kw = ANTENNAS[antenna]
    ant_j, ant_t = getattr(j_cfg, kind)(**kw), getattr(t_cfg, kind)(**kw)
    az = np.array([-70.0, -3.5, 0.0, 18.4, 45.0, 89.0])
    el = np.array([-20.0, 0.0, 5.0, 12.0, 33.0, -60.0])
    if kind == "UPA":
        # one angle at a time: with several, the reference's UPA form fails to
        # broadcast (and with it every UPA scan grid); the port does the same
        for fn, ant in ((j_sen.steering_vector, ant_j), (t_sen.steering_vector, ant_t)):
            with pytest.raises(ValueError, match="broadcast"):
                fn(ant, 0.0857, az, el)
        for a1, e1 in zip(az, el):
            a_j = j_sen.steering_vector(ant_j, 0.0857, np.array([a1]), np.array([e1]))
            a_t = t_sen.steering_vector(ant_t, 0.0857, np.array([a1]), np.array([e1]))
            assert a_t.shape == a_j.shape == (ant_t.num_elements, 1)
            np.testing.assert_allclose(a_t, a_j, rtol=HOST_RTOL, atol=0)
        return
    a_j = j_sen.steering_vector(ant_j, 0.0857, az, el)
    a_t = t_sen.steering_vector(ant_t, 0.0857, az, el)
    assert a_t.shape == a_j.shape == (ant_t.num_elements, 6)
    np.testing.assert_allclose(a_t, a_j, rtol=HOST_RTOL, atol=0)


# ------------------------------------------------------------------------- echo


LOS_CASES = {"1tgt": (TARGETS_1, None), "3tgt": (TARGETS_3, None),
             "3tgt-1nlos": (TARGETS_3, (True, False, True))}


@pytest.mark.parametrize("case", list(LOS_CASES))
def test_radar_echo_constants_equal(case):
    targets, los = LOS_CASES[case]
    (_, _, pj), (_, _, pt) = _setup(targets=targets)
    los = None if los is None else np.asarray(los)
    for a, b in zip(t_echo.radar_echo_constants(pt, los), j_echo.radar_echo_constants(pj, los)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=HOST_RTOL, atol=0)


@pytest.mark.parametrize("case,antenna", [(c, "ula8x2") for c in LOS_CASES]
                         + [("3tgt-1nlos", "ula4"), ("1tgt", "upa2x4"), ("1tgt", "upa2x2x2")])
def test_apply_radar_channel_equal(case, antenna):
    targets, los = LOS_CASES[case]
    (gj, cj, pj), (gt, ct, pt) = _setup(antenna, targets)
    los = None if los is None else np.asarray(los)
    rng = np.random.default_rng(5)
    wave = 30.0 * _cplx(rng, 2 * 7680, gt.num_tx_ants)  # two slots of samples
    want = np.asarray(j_echo.apply_radar_channel(jnp.asarray(wave), pj, jax.random.PRNGKey(0),
                                                 target_los=los, add_noise=False))
    got = t_echo.apply_radar_channel(_t(wave), pt, target_los=los)
    assert got.shape == want.shape and got.T.is_contiguous()
    _close(got.numpy(), want)
    # the zero-fill delay: nothing arrives before the nearest LoS target's echo
    shift, c, _, _ = t_echo.radar_echo_constants(pt, los)
    first = int(shift[np.abs(c) > 0].min())
    assert first > 0 and not got[:first].any() and got[first].any()
    # a ready-made noise array takes the place of the draw
    noise = (np.sqrt(pt.n0 / 2.0) * np.sqrt(2.0) * _cplx(rng, *wave.shape)).astype(np.complex64)
    got_n = t_echo.apply_radar_channel(_t(wave), pt, target_los=los, noise=_t(noise))
    _close(got_n.numpy(), want + noise)


def test_apply_radar_channel_no_targets():
    (_, _, pj), (gt, _, pt) = _setup(targets=(np.zeros((0, 3)), (), ()))
    wave = _cplx(np.random.default_rng(1), 400, gt.num_tx_ants)
    want = np.asarray(j_echo.apply_radar_channel(jnp.asarray(wave), pj, jax.random.PRNGKey(0),
                                                 add_noise=False))
    got = t_echo.apply_radar_channel(_t(wave), pt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_radar_channel_generator_noise():
    """Same seed, same bits; another seed, other bits; per-part variance N0/2
    (200k samples x 16 antennas x 2 parts: the sample variance of 6.4M draws
    has a relative sigma of 6e-4, so 2% is a very wide gate)."""
    (_, _, _), (gt, _, pt) = _setup()
    wave = torch.zeros((200_000, gt.num_tx_ants), dtype=torch.complex64)

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return t_echo.apply_radar_channel(wave, pt, g)

    a, b, c = draw(3), draw(3), draw(4)
    assert a.dtype == torch.complex64 and torch.equal(a, b) and not torch.equal(a, c)
    re, im = a.real.double(), a.imag.double()
    assert float(re.var()) == pytest.approx(pt.n0 / 2.0, rel=0.02, abs=0)
    assert float(im.var()) == pytest.approx(pt.n0 / 2.0, rel=0.02, abs=0)
    assert float((a.abs() ** 2).double().mean()) == pytest.approx(pt.n0, rel=0.02, abs=0)
    assert abs(float((re * im).mean())) < 0.01 * pt.n0


def test_mono_static_sensing_equal():
    (gj, cj, pj), (gt, ct, pt) = _setup(targets=TARGETS_2, num_slots=2)
    rng = np.random.default_rng(6)
    grid = _qpsk_grid(rng, gt, 28, ct.n_sc)
    wave = np.asarray(j_ofdm.ofdm_modulate(jnp.asarray(grid), cj.ofdm)).T
    noise = (np.sqrt(pt.n0) * _cplx(rng, *wave.shape)).astype(np.complex64)
    rx = j_echo.apply_radar_channel(jnp.asarray(wave), pj, jax.random.PRNGKey(0),
                                    add_noise=False) + jnp.asarray(noise)
    want = np.asarray(j_ofdm.ofdm_demodulate(rx.T, cj.ofdm, cj.n_sc, 2))
    got = t_echo.mono_static_sensing(_t(wave), pt, ct.ofdm, ct.n_sc, 2, noise=_t(noise))
    _close(got.numpy(), want)


# -------------------------------------------------------------------------- rdm


@pytest.mark.parametrize("n_ants,n_sym,n_sc,n_ifft,n_fft,win", [
    (4, 28, 288, 512, 32, "kaiser"),  # both FFTs zero-pad
    (2, 70, 288, 512, 64, "kaiser"),  # n_sym > n_fft: the Doppler FFT trims
    (3, 56, 120, 128, 64, "hamming"),
    (1, 14, 48, 64, 8, "rect"),  # trims 14 -> 8
])
def test_range_doppler_map_equal(n_ants, n_sym, n_sc, n_ifft, n_fft, win):
    rng = np.random.default_rng(n_sym)
    rx, tx = _cplx(rng, n_ants, n_sym, n_sc), _cplx(rng, n_ants, n_sym, n_sc)
    want = np.asarray(j_sen.range_doppler_map(jnp.asarray(rx), jnp.asarray(tx), n_ifft, n_fft,
                                              win))
    got = t_sen.range_doppler_map(_t(rx), _t(tx), n_ifft, n_fft, win)
    assert got.shape == (n_ants, n_ifft, n_fft)
    _close(got.numpy(), want)
    np.testing.assert_allclose(t_sen.rdm_power(got).numpy(), np.asarray(j_sen.rdm_power(want)),
                               rtol=0, atol=2 * WAVE_TOL * float(np.abs(want).max()) ** 2)


def test_range_doppler_map_trim_uses_the_first_symbols():
    """With n_sym > n_fft the map ignores the symbols past n_fft (after
    windowing with the n_sym-long window), as numpy's fft(n=) does."""
    rng = np.random.default_rng(8)
    rx, tx = _cplx(rng, 1, 40, 48), _cplx(rng, 1, 40, 48)
    a = t_sen.range_doppler_map(_t(rx), _t(tx), 64, 32)
    rx2 = rx.copy()
    rx2[:, 32:] = 0.0
    np.testing.assert_array_equal(a.numpy(), t_sen.range_doppler_map(_t(rx2), _t(tx), 64, 32).numpy())
    rx2[:, 31] = 0.0
    assert not torch.equal(a, t_sen.range_doppler_map(_t(rx2), _t(tx), 64, 32))


# ------------------------------------------------------------------------- cfar


@pytest.mark.parametrize("pfa,n", [(1e-9, 24), (1e-6, 24), (1e-3, 8), (0.1, 120)])
def test_ca_threshold_factor_equal(pfa, n):
    assert t_cfar.ca_threshold_factor(pfa, n) == j_cfar.ca_threshold_factor(pfa, n)


@pytest.mark.parametrize("kw", [{}, dict(guard=(1, 3), training=(2, 1), pfa=1e-4)])
def test_cfar_config_equal(kw):
    a, b = t_cfar.CFARConfig(**kw), j_cfar.CFARConfig(**kw)
    assert (a.num_training, a.threshold_factor) == (b.num_training, b.threshold_factor)
    assert vars(a) == vars(b)


@pytest.mark.parametrize("num_slots,bw", [(4, 10e6), (20, 20e6), (20, 100e6)])
def test_make_cfar_config_equal(num_slots, bw):
    (_, _, pj), (_, _, pt) = _setup(num_slots=num_slots, bw=bw)
    a, b = t_cfar.make_cfar_config(pt, 8), j_cfar.make_cfar_config(pj, 8)
    assert vars(a) == vars(b)
    assert a.zone_rows[1] > a.zone_rows[0] and a.zone_cols[1] > a.zone_cols[0]


def _planted_power(seed, shape, peaks):
    """Exponential noise floor (unit mean) with planted peaks, float32."""
    rng = np.random.default_rng(seed)
    power = rng.exponential(1.0, shape).astype(np.float32)
    for (r, c, v) in peaks:
        power[..., r, c] = v
    return power


CFAR_CASES = [
    # pfa 1e-2..1e-1 so that the noise floor itself crosses the threshold often
    (0, (96, 64), [(30, 40, 500.0), (60, 10, 80.0)],
     dict(pfa=1e-2, zone_rows=(5, 90), zone_cols=(5, 58), max_detections=8)),
    (1, (3, 80, 48), [(20, 20, 300.0), (21, 21, 290.0), (70, 40, 60.0)],
     dict(pfa=1e-1, zone_rows=(0, 79), zone_cols=(0, 47), max_detections=16)),
    (2, (2, 64, 64), [(2, 2, 1e4), (40, 63, 1e3)],
     dict(pfa=1e-3, guard=(1, 2), training=(2, 1), zone_rows=(0, 63), zone_cols=(0, 63),
          max_detections=4)),
]


@pytest.mark.parametrize("seed,shape,peaks,kw", CFAR_CASES)
def test_cfar_maps_and_detections_equal(seed, shape, peaks, kw):
    power = _planted_power(seed, shape, peaks)
    cj, ct = j_cfar.CFARConfig(**kw), t_cfar.CFARConfig(**kw)
    det_j = np.asarray(j_cfar.cfar_detect_map(jnp.asarray(power), cj))
    det_t = t_cfar.cfar_detect_map(_t(power), ct).numpy()
    assert det_t.dtype == np.bool_ and det_t.sum() > len(peaks)  # floor crossings too
    np.testing.assert_array_equal(det_t, det_j)
    # How close the nearest cell came to its threshold. The two box sums add
    # 49 (or 35) + 25 (or 15) float32 cells in different orders, which moves a
    # threshold by ~1e-6 of itself at most; over these seeded maps the nearest
    # cell is 2e-4 or more away (measured: 8.9e-4, 2.1e-4, 3.8e-3), so equal
    # maps are expected, not luck.
    gr, gc = ct.guard
    tr, tc = ct.training
    p64 = torch.as_tensor(power.astype(np.float64))
    noise = (t_cfar._box_sum(p64, gr + tr, gc + tc) - t_cfar._box_sum(p64, gr, gc)) / ct.num_training
    thr = ct.threshold_factor * noise
    margin = float(((p64 - thr).abs() / thr).min())
    assert margin > 1e-4, margin
    # extraction on the max over the leading axis, as fft_2d_estimate does
    pmax = power if power.ndim == 2 else power.max(axis=0)
    union = det_j if det_j.ndim == 2 else det_j.any(axis=0)
    dj = {k: np.asarray(v) for k, v in j_cfar.cfar_extract_detections(
        jnp.asarray(pmax), jnp.asarray(union), cj).items()}
    dt = {k: v.numpy() for k, v in t_cfar.cfar_extract_detections(
        _t(pmax), _t(union), ct).items()}
    np.testing.assert_array_equal(dt["valid"], dj["valid"])
    np.testing.assert_array_equal(dt["peak"], dj["peak"])
    v = dj["valid"]
    assert v.sum() >= 2
    np.testing.assert_array_equal(dt["row"][v], dj["row"][v])
    np.testing.assert_array_equal(dt["col"][v], dj["col"][v])
    for r, c, val in peaks:
        if not any((r2, c2) != (r, c) and abs(r2 - r) <= 1 and abs(c2 - c) <= 1 and v2 > val
                   for r2, c2, v2 in peaks):
            assert ((dt["row"] == r) & (dt["col"] == c) & dt["valid"]).any(), (r, c)


def test_box_sum_is_a_zero_padded_window_sum():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 50, (2, 9, 11)).astype(np.float32)  # integers: sums are exact
    want = np.asarray(j_cfar._box_sum(jnp.asarray(x), 2, 1))
    np.testing.assert_array_equal(t_cfar._box_sum(_t(x), 2, 1).numpy(), want)
    np.testing.assert_array_equal(t_cfar._box_sum(_t(x[0]), 2, 1).numpy(), want[0])
    assert want[0, 0, 0] == x[0, :3, :2].sum()


def test_detections_to_estimates_equal():
    (_, _, pj), (_, _, pt) = _setup(num_slots=20, bw=20e6)
    dets = {"row": np.array([3, 100, 7, 0], np.int32), "col": np.array([140, 0, 255, 9], np.int32),
            "peak": np.array([9.0, 4.0, 0.0, 0.0], np.float32),
            "valid": np.array([True, True, False, False])}
    want = j_cfar.detections_to_estimates({k: jnp.asarray(v) for k, v in dets.items()}, pj)
    got = t_cfar.detections_to_estimates({k: _t(v) for k, v in dets.items()}, pt)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_top_k_order_is_jax_top_k_order(k):
    """Ties, -inf entries and zeros of both signs: values and indices equal
    `jax.lax.top_k`'s, which gives the lowest index first among equals."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, 40).astype(np.float32)
    x[rng.random(40) < 0.3] = -np.inf
    x[5], x[6] = 0.0, -0.0
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(x), k)
    vals_t, idx_t = t_cfar.top_k_lowest_index_first(_t(x), k)
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    finite = np.isfinite(np.asarray(vals_j))
    sel = finite & (np.asarray(vals_j) != 0.0)  # +-0.0 compare equal but order by sign here
    np.testing.assert_array_equal(idx_t.numpy()[sel], np.asarray(idx_j)[sel])
    assert len(set(idx_t.tolist())) == k


# -------------------------------------------------------------------------- doa


def _two_source_cov(antenna, az_true, el_true, seed, n_snap=512):
    kind, kw = ANTENNAS[antenna]
    a = t_sen.steering_vector(getattr(t_cfg, kind)(**kw), 299792458.0 / 3.5e9,
                              np.asarray(az_true), np.asarray(el_true))
    rng = np.random.default_rng(seed)
    k = len(az_true)
    s = (rng.standard_normal((k, n_snap)) + 1j * rng.standard_normal((k, n_snap))) / np.sqrt(2)
    x = a @ s + 0.01 * (rng.standard_normal((a.shape[0], n_snap))
                        + 1j * rng.standard_normal((a.shape[0], n_snap)))
    return (x @ x.conj().T / n_snap).astype(np.complex64)


DOA_CASES = [("ula8x2", (-30.0, 40.0), (0.0, 0.0)), ("ula4", (-12.0, 25.0), (0.0, 0.0)),
             ("ula8x2", (5.0, 21.0), (0.0, 0.0))]


@pytest.mark.parametrize("antenna,az_true,el_true", DOA_CASES)
@pytest.mark.parametrize("method", ["music", "music-counted", "music-gap", "beamscan", "mvdr"])
def test_doa_methods_equal(antenna, az_true, el_true, method):
    (_, _, pj), (_, _, pt) = _setup(antenna)
    ra = _two_source_cov(antenna, az_true, el_true, seed=2)
    fj = {"beamscan": j_doa.beamscan_doa, "mvdr": j_doa.mvdr_doa}.get(method, j_doa.music_doa)
    ft = {"beamscan": t_doa.beamscan_doa, "mvdr": t_doa.mvdr_doa}.get(method, t_doa.music_doa)
    # "music-counted": a detection count of 7 is clipped to max_targets = 2 (a
    # count above the true 2 would put a noise eigenvector, which is anyone's
    # choice among near-equal eigenvalues, into the signal subspace)
    k = 2 if method == "music-counted" else 3
    kw_j = {"music": dict(num_det_static=2),
            "music-counted": dict(num_detections=jnp.asarray(7, jnp.int32))}.get(method, {})
    kw_t = {"music": dict(num_det_static=2),
            "music-counted": dict(num_detections=torch.tensor(7, dtype=torch.int32))}.get(method, {})
    want = {k_: np.asarray(v) for k_, v in fj(jnp.asarray(ra), pj, max_targets=k, **kw_j).items()}
    got = {k_: v.numpy() for k_, v in ft(_t(ra), pt, max_targets=k, **kw_t).items()}
    assert got.keys() == want.keys()
    assert got["spectrum"].dtype == want["spectrum"].dtype == np.float32
    if method == "beamscan":
        _close(got["spectrum"], want["spectrum"], tol=BEAMSCAN_TOL)
    else:
        np.testing.assert_allclose(got["spectrum"], want["spectrum"], rtol=SPEC_RTOL, atol=0)
    if method.startswith("music"):
        dj, dt = 1.0 / want["spectrum"].astype(np.float64), 1.0 / got["spectrum"].astype(np.float64)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=MUSIC_DENOM_TOL * dj.max())
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["azEst"], want["azEst"])  # NaN where not valid, in both
    np.testing.assert_array_equal(got["elEst"], want["elEst"])
    assert np.isnan(got["elEst"]).all()  # a ULA has no elevation aperture
    if method != "beamscan":  # beamscan cannot split sources inside one lobe
        for az in az_true:
            assert np.nanmin(np.abs(got["azEst"] - az)) < 3.0


def test_doa_on_a_upa_fails_like_the_reference():
    """The UPA scan grid needs the steering vector at 181 x 181 angles, which
    the reference's UPA form cannot broadcast: every DoA estimator raises
    there, and so does the port's (no feature the reference lacks)."""
    (_, _, pj), (_, _, pt) = _setup("upa2x4")
    ra = np.eye(8, dtype=np.complex64)
    for fn, p, x in ((j_doa.music_doa, pj, jnp.asarray(ra)), (t_doa.music_doa, pt, _t(ra)),
                     (j_doa.beamscan_doa, pj, jnp.asarray(ra)), (t_doa.beamscan_doa, pt, _t(ra))):
        with pytest.raises(ValueError, match="broadcast"):
            fn(x, p)


@pytest.mark.parametrize("eig,max_targets", [
    ((9.0, 8.5, 0.01, 0.009, 0.008), 4), ((5.0, 0.1, 0.09, 0.08), 4),
    ((3.0, 2.9, 2.8, 2.7, 1e-4), 2), ((1.0, 1.0, 1.0), 4), ((0.0, 0.0, 4.0, -1e-9), 3),
])
def test_estimate_num_targets_equal(eig, max_targets):
    e = np.asarray(eig, np.float32)[::-1].copy()
    want = int(j_doa.estimate_num_targets(jnp.asarray(e), max_targets))
    assert int(t_doa.estimate_num_targets(_t(e), max_targets)) == want


@pytest.mark.parametrize("spec", [
    (1.0, 3.0, 2.0, 5.0, 4.0, 4.5, 0.5), (5.0, 1.0, 1.0, 1.0, 7.0),  # a plateau; both edges
    (2.0, 2.0, 2.0, 2.0), (1.0, 2.0, 3.0, 4.0), (0.0, 9.0, 9.0, 0.0, 3.0, 0.0),
])
def test_pick_peaks_equal(spec):
    s = np.asarray(spec, np.float32)
    idx_j, valid_j = (np.asarray(v) for v in j_doa._pick_peaks(jnp.asarray(s), 3))
    idx_t, valid_t = (v.numpy() for v in t_doa._pick_peaks(_t(s), 3))
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_array_equal(idx_t[valid_j], idx_j[valid_j])


def test_music_spectrum_depends_on_the_projector_only():
    """music_spectrum vs the reference's on the same covariance; eigenvectors
    themselves are not comparable (phase, rotation in the noise subspace)."""
    (_, _, pj), (_, _, pt) = _setup("ula8x2")
    ra = _two_source_cov("ula8x2", (-30.0, 40.0), (0.0, 0.0), seed=7)
    scan_j, _, _ = j_doa._scan_grid(pj.antenna, 0.0857, (180.0, 1.0), (180.0, 1.0), False)
    scan_t, az_t, el_t = t_doa._scan_grid(pt.antenna, 0.0857, (180.0, 1.0), (180.0, 1.0), False)
    np.testing.assert_allclose(scan_t, scan_j, rtol=HOST_RTOL, atol=0)
    assert az_t.shape == (181,) and np.isnan(el_t).all()
    want = np.asarray(j_doa.music_spectrum(jnp.asarray(ra), jnp.asarray(scan_j, jnp.complex64),
                                           jnp.asarray(2)))
    got = t_doa.music_spectrum(_t(ra), _t(scan_t.astype(np.complex64)), torch.tensor(2))
    np.testing.assert_allclose(got.numpy(), want, rtol=SPEC_RTOL, atol=0)
    np.testing.assert_allclose(1.0 / got.numpy().astype(np.float64), 1.0 / want.astype(np.float64),
                               rtol=0, atol=MUSIC_DENOM_TOL * float((1.0 / want).max()))


def test_spatial_covariance_equal():
    g = _cplx(np.random.default_rng(3), 4, 14, 24)
    want = np.asarray(j_doa.spatial_covariance(jnp.asarray(g)))
    _close(t_doa.spatial_covariance(_t(g)).numpy(), want)


def _point_target_channel(p, n_sym, n_sc, targets, rng):
    """Element-wise channel of point targets at (range, velocity), plus noise."""
    lam = 299792458.0 / p.fc
    scs = 299792458.0 / (2.0 * p.r_max)
    k, m = np.arange(n_sc), np.arange(n_sym)
    h = sum(np.exp(-2j * np.pi * k[None, :] * scs * 2 * r / 299792458.0)
            * np.exp(2j * np.pi * m[:, None] * p.tsri * 2 * v / lam) for r, v in targets)
    return (h + 0.01 * _cplx(rng, n_sym, n_sc)).astype(np.complex64)


@pytest.mark.parametrize("targets", [((150.0, 10.0),), ((90.0, -20.0), (300.0, 25.0))],
                         ids=["1tgt", "2tgt"])
def test_music_2d_equal(targets):
    (_, _, pj), (_, _, pt) = _setup()
    ch = _point_target_channel(pt, 28, 96, targets, np.random.default_rng(12))
    want = {k: np.asarray(v) for k, v in
            j_doa.music_2d(jnp.asarray(ch), pj, max_targets=3, r_step=2.0, v_step=1.0).items()}
    got = {k: v.numpy() for k, v in
           t_doa.music_2d(_t(ch), pt, max_targets=3, r_step=2.0, v_step=1.0).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for r, v in targets:
        assert np.nanmin(np.abs(got["rngEst"] - r)) <= 2.0
        assert np.nanmin(np.abs(got["velEst"] - v)) <= 1.0


# ---------------------------------------------------------------------- metrics


def test_get_rmse_equal():
    (_, _, pj), (_, _, pt) = _setup(targets=TARGETS_3, num_slots=20, bw=20e6)
    est = {"rngEst": np.array([129.0, np.nan, 77.0, 400.0, 245.5], np.float32),
           "velEst": np.array([6.0, np.nan, -11.0, 1.0, np.nan], np.float32),
           "aziEst": np.array([19.0, np.nan, -37.0, 5.0, 150.0], np.float32),
           "eleEst": np.full(5, np.nan, np.float32)}
    a, b = t_metrics.get_rmse(est, pt), j_metrics.get_rmse(est, pj)
    assert a["numMatched"] == b["numMatched"] >= 2
    assert a.keys() == b.keys()
    for k in a:
        if k == "matches":
            assert len(a[k]) == len(b[k])
            for ma, mb in zip(a[k], b[k]):
                np.testing.assert_equal(ma, mb)
        else:
            np.testing.assert_equal(a[k], b[k])
    np.testing.assert_equal(t_metrics.get_rmse({"rngEst": est["rngEst"]}, pt),
                            j_metrics.get_rmse({"rngEst": est["rngEst"]}, pj))
    assert t_metrics._fold_ula_azimuth(135.0) == j_metrics._fold_ula_azimuth(135.0)


def test_get_rmse_upa_keeps_azimuth_unfolded():
    (_, _, pj), (_, _, pt) = _setup("upa2x4", targets=TARGETS_1)
    est = {"rngEst": np.array([129.5]), "velEst": np.array([7.5]), "aziEst": np.array([120.0]),
           "eleEst": np.array([-10.0])}
    np.testing.assert_equal(t_metrics.get_rmse(est, pt), j_metrics.get_rmse(est, pj))


def test_roc_pd_equal():
    snr = np.array([-5.0, 0.0, 5.0, 10.0, 13.0, 20.0])
    for pfa in (1e-9, 1e-6, 1e-2):
        np.testing.assert_array_equal(t_metrics.roc_pd(snr, pfa), j_metrics.roc_pd(snr, pfa))


# -------------------------------------------------------------------- the slice


def _reference_chain(gj, cj, pj, grids, starts, widths, num_slots, noise, algo, doa, los=None):
    """The reference engine's `_sensing_chain` (sim/cell.py), with the noise
    array added where its own draw would be."""
    info, n_sc, n_tx = cj.ofdm, cj.n_sc, gj.num_tx_ants
    tx_grid = jnp.zeros((n_tx, num_slots * 14, n_sc), jnp.complex64)
    for st, wdt, g in zip(starts, widths, grids):
        tx_grid = tx_grid.at[:, st * 14: st * 14 + wdt, :].set(jnp.asarray(g))
    tx_wave = j_ofdm.ofdm_modulate(tx_grid, info).T
    rx = j_echo.apply_radar_channel(tx_wave, pj, jax.random.PRNGKey(0), target_los=los,
                                    add_noise=False) + jnp.asarray(noise)
    rx_grid = j_ofdm.ofdm_demodulate(rx.T, info, n_sc, num_slots)
    if algo == "MUSIC":
        return j_sen.music_2d_estimate(rx_grid, tx_grid, pj, doa_method=doa)
    return j_sen.fft_2d_estimate(rx_grid, tx_grid, pj, j_sen.make_cfar_config(pj),
                                 doa_method=doa)


def _slice_inputs(num_slots, seed):
    """DDDSU: D slots carry 14 symbols, the S slot its 10 DL symbols, U nothing."""
    (gj, cj, pj), (gt, ct, pt) = _setup(targets=TARGETS_2, num_slots=num_slots)
    tdd = gt.tdd
    starts = tuple(s for s in range(num_slots) if tdd.slot_type(s) in "DS")
    widths = tuple(14 if tdd.slot_type(s) == "D" else tdd.num_dl_syms for s in starts)
    rng = np.random.default_rng(seed)
    grids = [_qpsk_grid(rng, gt, w, ct.n_sc) for w in widths]
    n = int(ct.ofdm.symbol_lengths_slots(num_slots).sum())
    # 30 dB above the thermal floor (still ~30 dB under the echoes): the
    # eigenvalue-gap count of the MUSIC chain then reads noise eigenvalues that
    # are the noise's, not float32 rounding of the two large ones, which two
    # eigensolvers would round differently
    noise = (np.sqrt(1e3 * pt.n0) * _cplx(rng, n, gt.num_tx_ants)).astype(np.complex64)
    return (gj, cj, pj), (gt, ct, pt), starts, widths, grids, noise


@pytest.mark.parametrize("doa", ["music", "beamscan", "mvdr"])
def test_sensing_chain_fft_equal(doa):
    num_slots = 10
    (gj, cj, pj), (gt, ct, pt), starts, widths, grids, noise = _slice_inputs(num_slots, 21)
    want = _reference_chain(gj, cj, pj, grids, starts, widths, num_slots, noise, "FFT", doa)
    want = {k: np.asarray(v) for k, v in want.items()}
    chain, params = make_sensing_chain(gt, ct, *TARGETS_2, num_slots, starts, widths,
                                       algo="FFT", doa_method=doa, device="cpu")
    got = {k: v.numpy() for k, v in chain([_t(g) for g in grids], _t(noise)).items()}
    assert got.keys() == want.keys()
    assert got["rdm"].shape == (gt.num_tx_ants, params.n_ifft, params.n_fft)
    _close(got["rdm"], want["rdm"])
    for k in ("valid", "rngEst", "velEst", "eleEst"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)  # NaN-masked alike
    # MUSIC masks its peaks by the CFAR count; beamscan and MVDR report every
    # local maximum, and beyond the targets' two those are float32 ripples
    n_cmp = 4 if doa == "music" else 2
    for k in ("doa_valid", "aziEst"):
        np.testing.assert_array_equal(got[k][:n_cmp], want[k][:n_cmp], err_msg=k)
    np.testing.assert_allclose(got["peak"], want["peak"], rtol=1e-4, atol=0)
    assert got["valid"].sum() >= 2  # both targets (and a Doppler ghost of the TDD gaps)
    rep_t = t_sen.get_rmse({k: v for k, v in got.items() if k != "rdm"}, params)
    rep_j = j_sen.get_rmse({k: v for k, v in want.items() if k != "rdm"}, pj)
    assert rep_t["numMatched"] == rep_j["numMatched"] == 2
    for k in ("rngRMSE", "velRMSE", "aziRMSE"):
        assert rep_t[k] == pytest.approx(rep_j[k], rel=1e-9)


def test_sensing_chain_music_equal():
    num_slots = 5
    (gj, cj, pj), (gt, ct, pt), starts, widths, grids, noise = _slice_inputs(num_slots, 22)
    want = _reference_chain(gj, cj, pj, grids, starts, widths, num_slots, noise, "MUSIC", "music")
    want = {k: np.asarray(v) for k, v in want.items()}
    chain, _ = make_sensing_chain(gt, ct, *TARGETS_2, num_slots, starts, widths, algo="music",
                                  device="cpu")
    got = {k: v.numpy() for k, v in chain([_t(g) for g in grids], _t(noise)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["valid"].any() and got["doa_valid"].any()


def test_sensing_chain_nlos_target_vanishes():
    num_slots = 10
    (gj, cj, pj), (gt, ct, pt), starts, widths, grids, noise = _slice_inputs(num_slots, 23)
    los = np.array([True, False])
    want = _reference_chain(gj, cj, pj, grids, starts, widths, num_slots, noise, "FFT", "music",
                            los=los)
    chain, _ = make_sensing_chain(gt, ct, *TARGETS_2, num_slots, starts, widths, target_los=los,
                                  device="cpu")
    got = chain([_t(g) for g in grids], _t(noise))
    for k in ("valid", "rngEst", "velEst", "aziEst"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    rng_est = got["rngEst"].numpy()
    near, far = pt.range_m[1], pt.range_m[0]  # the NLoS target is the nearer one
    assert np.nanmin(np.abs(rng_est - far)) < 2 * pt.r_res
    assert np.nanmin(np.abs(rng_est - near)) > 2 * pt.r_res


def test_sensing_chain_generator_and_arguments():
    num_slots = 5
    _, (gt, ct, pt), starts, widths, grids, _ = _slice_inputs(num_slots, 24)
    chain, _ = make_sensing_chain(gt, ct, *TARGETS_2, num_slots, starts, widths, device="cpu")
    tg = [_t(g) for g in grids]

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return chain(tg, g)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["rdm"], b["rdm"]) and not torch.equal(a["rdm"], c["rdm"])
    assert torch.equal(a["valid"], c["valid"])  # the noise is ~60 dB under the echoes
    with pytest.raises(ValueError):
        chain(tg[:-1])
    with pytest.raises(ValueError):
        make_sensing_chain(gt, ct, *TARGETS_2, num_slots, starts, widths, algo="ESPRIT",
                           device="cpu")
    with pytest.raises(ValueError):
        make_sensing_chain(gt, ct, *TARGETS_2, num_slots, starts, widths, doa_method="esprit",
                           device="cpu")[0](tg)


def test_example_sensing_small():
    from isac_tpu_torch.example import example_sensing

    gnb = t_cfg.GNBParams(dl_bandwidth=10e6, ul_bandwidth=10e6,
                          antenna=t_cfg.ULA(n_v=8, polarizations=2))
    chain, params, grids = example_sensing(num_slots=10, device="cpu", gnb=gnb)
    assert grids[0].shape == (16, 140, 288) and grids[0].dtype == torch.complex64
    g = torch.Generator()
    g.manual_seed(0)
    est = chain(grids, g)
    rep = t_sen.get_rmse({k: v.numpy() for k, v in est.items() if k != "rdm"}, params)
    assert rep["numDetections"] == rep["numMatched"] == 1
    assert rep["rngRMSE"] < 2 * params.r_res and rep["velRMSE"] < params.v_res
    assert rep["aziRMSE"] < 1.0


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    gnb = t_cfg.GNBParams(dl_bandwidth=10e6, ul_bandwidth=10e6)
    with pytest.raises(RuntimeError):
        make_sensing_chain(gnb, gnb.carrier, *TARGETS_1, 5, (0,), (14,))
