"""Range-Doppler map via windowed 2D (I)FFT + matched-filter channel extraction.

Counterpart of +sensing/+estimation/fft2D.m:30-116.

Grid layout here is [n_ants, n_sym, n_sc] (the reference's [nSc, nSym, nAnts]
transposed for last-axis FFTs). Chain:
  H = rx * conj(tx)                      (element-wise matched filter, :37)
  H *= rngWin[sc] ; R = IFFT_sc(H)*sqrt(nIFFT)    (:40-44; range along sc)
  R *= dopWin[sym]
  RDM = fftshift_dop(FFT_sym(R)/sqrt(nFFT))       (:46; Doppler centered)

Deviations from the MATLAB reference (shared with the JAX package):
- the MATLAB code's bare `ifftshift(...)`/`fftshift(...)` shift ALL axes; the two
  calls cancel on the range/antenna axes and amount to a pre-FFT circular
  rotation of the symbol axis. The shift is applied purely on the Doppler axis
  after the FFT, which is the intended processing.
- the MATLAB code applies the Doppler window along the range-bin axis
  (fft2D.m:145-147); here the symbol axis is windowed before the Doppler FFT.

The Doppler window has the grid's n_sym entries and the Doppler FFT takes
`n=n_fft`: when n_fft < n_sym (n_fft is derived from the DL symbols only, the
grid holds every symbol) the FFT TRIMS to the first n_fft windowed symbols, as
numpy's and the JAX package's do. That is the reference's behaviour and is kept.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.ops import dft
from isac_tpu_torch.utils.windows import window


@lru_cache(maxsize=32)
def _window_dev(kind: str, n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(window(kind, n).astype(np.float32), device=device)


def range_doppler_map(
    rx_grid: torch.Tensor,
    tx_grid: torch.Tensor,
    n_ifft: int,
    n_fft: int,
    win: str = "kaiser",
) -> torch.Tensor:
    """[n_ants, n_sym, n_sc] x2 -> RDM [n_ants, n_ifft(range), n_fft(Doppler)]
    matching the reference's [nIFFT x nFFT x nAnts] layout per antenna.

    Doppler axis is fftshift-centered (bin k => velocity (k - n_fft/2) * vRes);
    range bin r => range r * rRes.
    """
    n_sym, n_sc = rx_grid.shape[-2:]
    dev = rx_grid.device
    h = rx_grid * torch.conj(tx_grid)
    h = h.mul_(_window_dev(win, n_sc, dev)[None, None, :])
    r = dft.ifft_auto(h, n=n_ifft, axis=-1).mul_(float(np.sqrt(n_ifft)))  # range profile
    del h
    r = r.mul_(_window_dev(win, n_sym, dev)[None, :, None])
    rdm = dft.fft_auto(r, n=n_fft, axis=-2).div_(float(np.sqrt(n_fft)))  # Doppler
    del r
    rdm = torch.fft.fftshift(rdm, dim=-2)  # [n_ants, n_fft, n_ifft]
    return rdm.transpose(-1, -2)  # -> [n_ants, n_ifft(range), n_fft(Doppler)]


def rdm_power(rdm: torch.Tensor) -> torch.Tensor:
    return torch.abs(rdm) ** 2
