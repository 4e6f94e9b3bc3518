"""CP-OFDM modulation/demodulation per TS 38.211 §5.3.1 (normal CP).

Counterparts of MATLAB nrOFDMModulate / nrOFDMDemodulate / nrOFDMInfo
(reference call sites: gNBPhy.m:599, uePhy.m, monoStaticSensing.m:16).

Conventions:
- resource grids are [..., n_sym, n_sc] (batch dims lead; FFT along the last axis);
  the reference's [nSc, nSym, nAnts] MATLAB layout maps to [nAnts, nSym, nSc].
- subcarrier k occupies FFT bin (k - n_sc//2) mod nfft (DC at grid center);
- modulate follows the MATLAB ifft scaling (1/N inside the IFFT), demodulate is
  the exact inverse, so the reference's amplitude law
  db2mag(P_dBm-30) * sqrt(nfft^2 / (n_sc * n_ants))   (gNBPhy.m:592)
  carries over unchanged;
- ragged per-symbol CP lengths are handled with precomputed index maps: one
  `index_select` along the sample axis serialises the waveform (CP insertion)
  and one extracts the FFT windows. The reference package has a second,
  slice-and-reshape form of the same data movement for spans that start on a
  half-subframe boundary; one form serves both cases here. The index maps and
  the de-rotation phases are built once per (numerology, span, device) and stay
  on the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.config.carrier import OFDMInfo
from isac_tpu_torch.ops import dft


@lru_cache(maxsize=32)
def _modulate_index(info: OFDMInfo, num_slots: int, first_slot: int,
                    device: torch.device) -> torch.Tensor:
    """Output sample -> flat index into the [n_sym * nfft] IFFT outputs."""
    sym_lens = info.symbol_lengths_slots(num_slots, first_slot).reshape(-1)
    cp_lens = info.cp_lengths_slots(num_slots, first_slot).reshape(-1)
    total = int(sym_lens.sum())
    sym_idx = np.repeat(np.arange(sym_lens.shape[0]), sym_lens)
    starts = np.concatenate([[0], np.cumsum(sym_lens)[:-1]])
    offset_in_sym = np.arange(total) - starts[sym_idx]
    # CP = tail of the IFFT output: sample = (offset - cp) mod nfft
    samp_idx = (offset_in_sym - cp_lens[sym_idx]) % info.nfft
    return torch.as_tensor(sym_idx * info.nfft + samp_idx, dtype=torch.int64, device=device)


@lru_cache(maxsize=32)
def _window_plan(info: OFDMInfo, num_slots: int, first_slot: int, cp_fraction: float):
    """(early [n_sym], win_start [n_sym], total): samples into the CP at which
    each FFT window starts, its first sample, and the span's sample count."""
    sym_lens = info.symbol_lengths_slots(num_slots, first_slot).reshape(-1)
    cp_lens = info.cp_lengths_slots(num_slots, first_slot).reshape(-1)
    starts = np.concatenate([[0], np.cumsum(sym_lens)[:-1]])
    early = np.floor(cp_lens * (1.0 - cp_fraction)).astype(np.int64)
    return early, starts + cp_lens - early, int(sym_lens.sum())


@lru_cache(maxsize=32)
def _demodulate_index(info: OFDMInfo, num_slots: int, first_slot: int, cp_fraction: float,
                      device: torch.device) -> torch.Tensor:
    """Flat [n_sym * nfft] sample index of the FFT windows."""
    _, win_start, _ = _window_plan(info, num_slots, first_slot, cp_fraction)
    gather = win_start[:, None] + np.arange(info.nfft)[None, :]
    return torch.as_tensor(gather.reshape(-1), dtype=torch.int64, device=device)


@lru_cache(maxsize=32)
def _derotation(info: OFDMInfo, n_sc: int, num_slots: int, first_slot: int,
                cp_fraction: float, device: torch.device) -> torch.Tensor:
    """exp(+2 pi j k early / N) per (symbol, subcarrier), [n_sym, n_sc] complex64:
    starting `early` samples into the CP shifts the IFFT output circularly by
    -early, i.e. the FFT gives X_k * exp(-2 pi j k early / N). Built in float64."""
    early, _, _ = _window_plan(info, num_slots, first_slot, cp_fraction)
    k = ((np.arange(n_sc) - n_sc // 2) % info.nfft).astype(np.float64)
    phase = np.exp(+2j * np.pi * np.outer(early, k) / info.nfft).astype(np.complex64)
    return torch.as_tensor(phase, device=device)


def _grid_to_bins(grid: torch.Tensor, n_sc: int, nfft: int) -> torch.Tensor:
    """Centered grid -> FFT-bin layout via two slices + zero mid (no scatter)."""
    half = n_sc // 2
    grid = grid.to(torch.complex64)
    zeros = grid.new_zeros((*grid.shape[:-1], nfft - n_sc))
    return torch.cat([grid[..., half:], zeros, grid[..., :half]], dim=-1)


def _bins_to_grid(spec: torch.Tensor, n_sc: int, nfft: int) -> torch.Tensor:
    """FFT-bin layout -> centered grid (inverse of _grid_to_bins)."""
    half = n_sc // 2
    return torch.cat([spec[..., nfft - half:], spec[..., : n_sc - half]], dim=-1)


def ofdm_modulate(grid: torch.Tensor, info: OFDMInfo, first_slot: int = 0) -> torch.Tensor:
    """grid [..., n_sym, n_sc] -> waveform [..., total_samples].

    n_sym must be a multiple of symbols_per_slot; `first_slot` fixes which
    symbols carry the long CP (absolute slot position in the frame).
    """
    *lead, n_sym, n_sc = grid.shape
    if n_sym % info.symbols_per_slot:
        raise ValueError(f"n_sym {n_sym} not a multiple of {info.symbols_per_slot}")
    num_slots = n_sym // info.symbols_per_slot
    x = _grid_to_bins(grid, n_sc, info.nfft)
    time_syms = dft.ifft_auto(x, axis=-1)  # MATLAB ifft scaling (1/N)
    idx = _modulate_index(info, num_slots, first_slot, grid.device)
    return time_syms.reshape(*lead, n_sym * info.nfft).index_select(-1, idx)


def ofdm_demodulate(
    waveform: torch.Tensor,
    info: OFDMInfo,
    n_sc: int,
    num_slots: int,
    first_slot: int = 0,
    cp_fraction: float = 0.55,
) -> torch.Tensor:
    """waveform [..., total_samples] -> grid [..., num_slots*14, n_sc].

    The FFT window starts `floor(cp * (1 - cp_fraction))` samples into the CP
    (MATLAB nrOFDMDemodulate CyclicPrefixFraction semantics, default 0.55) and
    the resulting circular shift is de-rotated exactly per subcarrier, so
    demodulate(modulate(g)) == g in the absence of channel effects.
    """
    n_sym = num_slots * info.symbols_per_slot
    _, _, total = _window_plan(info, num_slots, first_slot, cp_fraction)
    if waveform.shape[-1] < total:
        waveform = torch.nn.functional.pad(waveform, (0, total - waveform.shape[-1]))
    idx = _demodulate_index(info, num_slots, first_slot, cp_fraction, waveform.device)
    windows = waveform.index_select(-1, idx).reshape(*waveform.shape[:-1], n_sym, info.nfft)
    spec = dft.fft_auto(windows, axis=-1)
    phase = _derotation(info, n_sc, num_slots, first_slot, cp_fraction, waveform.device)
    return _bins_to_grid(spec, n_sc, info.nfft) * phase
