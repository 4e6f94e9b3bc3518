"""Range-Doppler map of one antenna, in float64 NumPy (fft2D.m:30-116).

H = rx * conj(tx) per resource element; a Kaiser window (beta 3) over the
subcarriers, an inverse FFT of n_ifft points along them scaled by
sqrt(n_ifft) (range); a Kaiser window over the symbols, an FFT of n_fft points
along them (zero-filled, or trimmed to the first n_fft symbols) scaled by
1/sqrt(n_fft) (Doppler), centred on zero Doppler. Returns [n_ifft, n_fft].
"""

from __future__ import annotations

import numpy as np


def range_doppler_map(rx: np.ndarray, tx: np.ndarray, n_ifft: int, n_fft: int) -> np.ndarray:
    n_sym, n_sc = rx.shape
    h = rx.astype(np.complex128) * np.conj(tx.astype(np.complex128))
    h = h * np.kaiser(n_sc, 3.0)[None, :]
    r = np.fft.ifft(h, n=n_ifft, axis=-1) * np.sqrt(n_ifft)
    r = r * np.kaiser(n_sym, 3.0)[:, None]
    d = np.fft.fft(r, n=n_fft, axis=0) / np.sqrt(n_fft)
    return np.fft.fftshift(d, axes=0).T
