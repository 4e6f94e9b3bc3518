"""Mono-static multi-target radar echo channel.

Counterpart of +sensing/+channelModels/basicRadarChannel.m:1-76 and
+sensing/monoStaticSensing.m:1-23.

Baseband-equivalent form, two matrix products instead of a loop per target:
the reference upconverts to fc, integer-shifts, applies Doppler, rank-1 steers
per target, sums, adds noise, downconverts. The carrier round trip reduces to a
constant phase exp(-2j pi fc * s*Ts) per target (kept in float64 host-side;
float32 could not represent fc*t at 3.5 GHz). On the device the echo is:

    q      = wave @ A_tx            [N, T]   (steering projection)
    q_t[n] = q[n - s_t] * c_t * exp(2j pi fd_t n Ts)   (zero-fill shift + phase ramp)
    rx     = q_shift @ A_rx^T + AWGN(N0)     [N, n_ants]

with c_t = LSF_t * exp(-2j pi fc s_t Ts), zero for NLoS targets
(basicRadarChannel.m:58-59). Delay is an integer-sample zero-fill shift
(ceil(2r/c/Ts), :42) exactly as in the reference.

Randomness is explicit: the AWGN comes from the caller's `torch.Generator`, or
is a ready-made array (`noise=`), or is left out when both are None.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.config.carrier import OFDMInfo
from isac_tpu_torch.ops.ofdm import ofdm_demodulate
from isac_tpu_torch.ops.sensing.radar_params import RadarDerived
from isac_tpu_torch.utils.geometry import SPEED_OF_LIGHT


def radar_echo_constants(params: RadarDerived, target_los: np.ndarray | None = None):
    """Host-side per-target constants: (shift_samples[T], phase_const[T],
    doppler_hz[T], A[n_ants, T])."""
    ts = 1.0 / params.fs
    path_delay = 2.0 * params.range_m / SPEED_OF_LIGHT
    shift = np.ceil(path_delay / ts).astype(np.int64)  # (:22)
    lam = SPEED_OF_LIGHT / params.fc
    fd = 2.0 * params.velocity_ms / lam  # (:25)
    c = params.large_scale_fading * np.exp(-2j * np.pi * params.fc * shift * ts)
    if target_los is not None:
        c = np.where(np.asarray(target_los, bool), c, 0.0)
    return shift, c.astype(np.complex128), fd, params.steering


@lru_cache(maxsize=16)
def _echo_constants_dev(params: RadarDerived, los: tuple | None, device: torch.device):
    """The per-target constants on `device`, built once per (params, LoS flags,
    device): (shifts as ints, A [n_ants, T] c64, c_t [T] c64, ramp rate [T] f32).

    The ramp rate is f32(2 pi) * f32(fd * Ts): `fd * Ts` is rounded to float32
    BEFORE the product with 2 pi, and that product before the one with the
    sample index, the reference's order."""
    shift, cconst, fd, steer = radar_echo_constants(
        params, None if los is None else np.asarray(los, bool))
    rate = np.float32(2.0 * np.pi) * (fd * (1.0 / params.fs)).astype(np.float32)
    return (
        tuple(int(s) for s in shift),
        torch.as_tensor(np.asarray(steer).astype(np.complex64), device=device),
        torch.as_tensor(cconst.astype(np.complex64), device=device),
        torch.as_tensor(rate, device=device),
    )


def apply_radar_channel(
    tx_wave: torch.Tensor,
    params: RadarDerived,
    generator: torch.Generator | None = None,
    target_los: np.ndarray | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """tx_wave [N, n_ants] -> rx echo [N, n_ants] (baseband, complex64).

    AWGN of power N0 (sigma = sqrt(N0/2) per real part) is drawn from
    `generator`; `noise` [N, n_ants] complex64, when given, is added in its
    place; with neither the echo is noise-free.

    The result is the transposed view of an antenna-major buffer, so that
    `rx.T` — what OFDM demodulation takes — is contiguous.
    """
    n, n_ants = tx_wave.shape
    dev = tx_wave.device
    los = None if target_los is None else tuple(bool(v) for v in np.asarray(target_los).ravel())
    shift, a, cconst, rate = _echo_constants_dev(params, los, dev)
    if noise is None and generator is not None:
        sigma = float(np.sqrt(params.n0 / 2.0))
        noise_t = torch.view_as_complex(
            torch.randn((n_ants, n, 2), generator=generator, device=dev, dtype=torch.float32)
        ).mul_(sigma)
    else:
        noise_t = None if noise is None else noise.to(torch.complex64).T
    t_count = len(shift)
    if t_count == 0:
        rx_t = torch.zeros((n_ants, n), dtype=torch.complex64, device=dev)
        return (rx_t if noise_t is None else rx_t + noise_t).T
    q = torch.matmul(tx_wave.to(torch.complex64), a)  # [N, T]
    # integer zero-fill delay per target (the shifts are host constants)
    q_shift = torch.zeros_like(q)
    for t, s in enumerate(shift):
        if s < n:
            q_shift[s:, t] = q[: n - s, t]
    # Doppler ramp on the post-shift sample clock (the reference applies the ramp
    # from t=0 after shifting: basicRadarChannel.m:43-45)
    phase = rate[None, :] * torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    q_shift = q_shift * torch.complex(torch.cos(phase), torch.sin(phase)) * cconst[None, :]
    if noise_t is None:
        rx_t = torch.matmul(a, q_shift.T)  # [n_ants, N]
    else:
        rx_t = torch.addmm(noise_t, a, q_shift.T)
    return rx_t.T


def mono_static_sensing(
    tx_wave: torch.Tensor,
    params: RadarDerived,
    info: OFDMInfo,
    n_sc: int,
    num_slots: int,
    generator: torch.Generator | None = None,
    target_los: np.ndarray | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """tx waveform -> echo grid [n_ants, n_sym, n_sc] (monoStaticSensing.m:1-23).

    tx_wave is [N, n_ants] (the accumulated DL waveform, zeros on UL slots)."""
    rx = apply_radar_channel(tx_wave, params, generator, target_los, noise)
    return ofdm_demodulate(rx.T, info, n_sc, num_slots)
