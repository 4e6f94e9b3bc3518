"""Spectral windows used by the sensing 2D-FFT chain (ref: fft2D.m selectWindow).

numpy host-side generation (setup-time constants); the callers cache them on
their device.
Default in the reference is kaiser(n, 3) (``+sensing/+estimation/fft2D.m:40``).
"""

from __future__ import annotations

import numpy as np


def _kaiser(n: int, beta: float) -> np.ndarray:
    return np.kaiser(n, beta)


def _hamming(n: int) -> np.ndarray:
    return np.hamming(n)


def _hann(n: int) -> np.ndarray:
    return np.hanning(n)


def _blackman(n: int) -> np.ndarray:
    return np.blackman(n)


def _gauss(n: int, alpha: float = 2.5) -> np.ndarray:
    k = np.arange(n) - (n - 1) / 2.0
    sigma = (n - 1) / (2.0 * alpha)
    return np.exp(-0.5 * (k / sigma) ** 2)


def _tukey(n: int, r: float = 0.5) -> np.ndarray:
    if r <= 0:
        return np.ones(n)
    if r >= 1:
        return _hann(n)
    x = np.linspace(0, 1, n)
    w = np.ones(n)
    lo = x < r / 2
    hi = x >= 1 - r / 2
    w[lo] = 0.5 * (1 + np.cos(2 * np.pi / r * (x[lo] - r / 2)))
    w[hi] = 0.5 * (1 + np.cos(2 * np.pi / r * (x[hi] - 1 + r / 2)))
    return w


def _barthann(n: int) -> np.ndarray:
    x = np.abs(np.arange(n) / (n - 1) - 0.5)
    return 0.62 - 0.48 * x + 0.38 * np.cos(2 * np.pi * x)


def window(kind: str, n: int) -> np.ndarray:
    """Window by name; mirrors the window set in fft2D.m:125-148."""
    kind = kind.lower()
    table = {
        "kaiser": lambda: _kaiser(n, 3.0),
        "hamming": lambda: _hamming(n),
        "hann": lambda: _hann(n),
        "blackman": lambda: _blackman(n),
        "gausswin": lambda: _gauss(n),
        "tukeywin": lambda: _tukey(n),
        "barthannwin": lambda: _barthann(n),
        "rect": lambda: np.ones(n),
    }
    if kind not in table:
        raise ValueError(f"unknown window '{kind}' (supported: {sorted(table)})")
    return table[kind]().astype(np.float64)
