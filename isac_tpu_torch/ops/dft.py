"""DFT entry points of the OFDM / range-Doppler / SRS paths.

Every FFT call site of those paths goes through `fft_auto` / `ifft_auto`, as
in the reference package. Here they are `torch.fft.fft` / `torch.fft.ifft`
(cuFFT on the card, pocketfft on the CPU) with numpy's meaning of `n=` (zero-pad
or trim to the FIRST n entries) and `axis=`, and the 1/n scale inside the
inverse.

Not ported: the reference's two-stage matrix-product DFT (`fft_matmul`) and its
`_use_matmul` switch (the ISAC_TPU_MATMUL_DFT opt-in). They exist for the TPU's
matrix unit and its relay; the reference's CPU form, which is the parity
contract, always takes the library FFT.
"""

from __future__ import annotations

import torch


def fft_auto(x: torch.Tensor, n: int | None = None, axis: int = -1) -> torch.Tensor:
    return torch.fft.fft(x, n=n, dim=axis)


def ifft_auto(x: torch.Tensor, n: int | None = None, axis: int = -1) -> torch.Tensor:
    return torch.fft.ifft(x, n=n, dim=axis)
