"""Waveform-domain reception path (counterpart of isac_tpu/phy/waveform_rx.py).

Parity surface: +communication/+phyLayer/phyRxBuffer.m:137-228 (arbitrary
time-overlapping waveform summation with resampling at the receive buffer)
and gNBPhy.m:916-920 (nrTimingEstimate + skipWeakTimingOffset before OFDM
demodulation).

The default model of the chains stays frequency-domain per symbol (per-RE
channel application); this module is the explicit waveform path for the
cases where time structure matters — unknown timing offsets, overlapping
asynchronous transmissions, sample-rate mismatch:

- `overlap_add`: sum of waveforms at arbitrary sample offsets into one
  receive buffer, clipped at the buffer's ends.
- `resample_linear`: sample-rate conversion by linear interpolation.
- `waveform_receive`: timing estimate (correlation + the 5.5x weak-peak skip
  rule, ops/channel_est.py:timing_estimate) -> aligned slice -> OFDM
  demodulate -> the standard canonical-grid receiver. The estimated offset is
  read back to the host to take the slice (one device-to-host read).
"""

from __future__ import annotations

import numpy as np
import torch

from isac_tpu_torch.config.carrier import OFDMInfo
from isac_tpu_torch.ops.channel_est import timing_estimate
from isac_tpu_torch.ops.ofdm import ofdm_demodulate, ofdm_modulate
from isac_tpu_torch.phy.chains import (
    SCHGrant,
    _dmrs_port_grid,
    _grant_constants,
    _layout,
    _sc_full,
    dmrs_ports,
    sch_receive,
)


def overlap_add(waveforms: list, offsets, n_total: int) -> torch.Tensor:
    """Sum waveforms [n_rx, n_i] at sample offsets into a buffer of n_total
    samples (phyRxBuffer.m:224-225: `sum(packetsOfInterest)` after aligning
    each stored packet into the buffer window). Samples falling outside the
    buffer window are CLIPPED, matching the reference buffer's windowing
    (phyRxBuffer.m:169-228): a tail past the end never wraps to the head, and
    a negative offset clips the packet head."""
    first = waveforms[0]
    buf = torch.zeros((first.shape[0], n_total), dtype=torch.complex64, device=first.device)
    for w, off in zip(waveforms, offsets):
        off = int(off)
        n = w.shape[-1]
        lo, hi = max(off, 0), min(off + n, n_total)
        if hi > lo:
            buf[:, lo:hi] = buf[:, lo:hi] + w[:, lo - off: hi - off]
    return buf


def resample_linear(wave: torch.Tensor, in_rate: float, out_rate: float) -> torch.Tensor:
    """Rate-convert [..., N] from in_rate to out_rate by linear interpolation
    (phyRxBuffer.m:137-168 `resample(...)` analogue)."""
    n_out = int(round(wave.shape[-1] * out_rate / in_rate))
    ratio = float(np.float32(in_rate / out_rate))
    pos = torch.arange(n_out, dtype=torch.float32, device=wave.device) * ratio
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, wave.shape[-1] - 2)
    frac = pos - i0.to(torch.float32)
    a = wave[..., i0]
    b = wave[..., i0 + 1]
    return a + (b - a) * frac.to(wave.dtype)


def waveform_receive(
    rx_wave: torch.Tensor,  # [n_rx, n_samples] (>= slot_samples + max_offset)
    grant: SCHGrant,
    info: OFDMInfo,
    ref_wave: torch.Tensor,  # DM-RS-bearing reference waveform [n_ref]
    max_offset: int,
    n_ldpc_iter: int = 6,
    threshold: float = 5.5,
    soft_buffers=None,
):
    """Timing-estimate + align + demodulate + decode (gNBPhy.m:916-935).

    Returns sch_receive's dict plus `timing_offset` (the estimated sample
    offset; 0 when the correlation peak fails the 5.5x skip-weak rule)."""
    n_slot_samples = info.slot_samples(0)
    off = timing_estimate(rx_wave, ref_wave, max_offset, threshold=threshold)
    start = int(off)
    aligned = rx_wave[..., start: start + n_slot_samples]
    grid = ofdm_demodulate(aligned, info, grant.n_sc_grid, 1)
    out = sch_receive(grid, grant, soft_buffers=soft_buffers, n_ldpc_iter=n_ldpc_iter)
    out["timing_offset"] = off
    return out


def reference_waveform(grant: SCHGrant, info: OFDMInfo, device=None) -> torch.Tensor:
    """The correlation reference: the grant's DM-RS-ONLY slot waveform
    (nrTimingEstimate correlates against a refGrid holding just the known
    DM-RS — payload REs stay empty, which keeps the correlation floor low
    enough for the 5.5x skip-weak rule to accept true peaks).

    device: None means the card (raises without one)."""
    from isac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    lay = _layout(grant.layout_key())
    _, refs = _grant_constants(grant, lay, dev)
    lg = _dmrs_port_grid(refs, dmrs_ports(grant.n_layers), lay["n_sc_c"], lay["dsyms"])
    full = torch.zeros((lg.shape[0], 14, grant.n_sc_grid), dtype=torch.complex64, device=dev)
    full[:, :, _sc_full(grant.prbs, dev)] = lg
    return torch.sum(ofdm_modulate(full, info), dim=0)  # sum ports -> [N]
