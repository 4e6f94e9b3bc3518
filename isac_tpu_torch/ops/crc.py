"""TS 38.212 §5.1 CRC attachment (counterpart of isac_tpu/ops/crc.py).

CRC as a GF(2) linear map: crc(m)_t = sum_i m_i * B[i, t] mod 2, with B built
on the host for the (static) message length. On the device the CRC is one
[.., n] x [n, L] float32 product followed by mod 2 — integer-exact for
n < 2^24 because every partial sum is an integer below 2^24, so the order of
the sum does not matter. It needs FULL float32: TF32 keeps 10 mantissa bits
and would round the sums, which is why utils.device.resolve_device switches
TF32 off at the port's entry points.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.utils.sequences import _extend_lfsr

# Generator polynomials g(x) = x^L + sum_{j in taps} x^j  (TS 38.212 §5.1)
CRC_POLYS = {
    "24A": (24, (23, 18, 17, 14, 11, 10, 7, 6, 5, 4, 3, 1, 0)),
    "24B": (24, (23, 6, 5, 1, 0)),
    "24C": (24, (23, 21, 20, 17, 15, 13, 12, 8, 4, 2, 1, 0)),
    "16": (16, (12, 5, 0)),
    "11": (11, (10, 9, 5, 0)),
    "6": (6, (5, 0)),
}


def crc_length(kind: str) -> int:
    return CRC_POLYS[kind][0]


@lru_cache(maxsize=64)
def crc_matrix(kind: str, n_bits: int) -> np.ndarray:
    """B s.t. crc(m) = (m @ B) mod 2 for an n_bits message, uint8 [n_bits, L]
    (column t = coefficient of x^t; message bit 0 is the highest degree)."""
    L, taps = CRC_POLYS[kind]
    lags = tuple(sorted(taps))
    init = np.eye(L, dtype=np.uint8)
    seqs = _extend_lfsr(init, n_bits + L, lags, degree=L)  # [n_bits+L, L]
    idx = n_bits - 1 - np.arange(n_bits) + L
    return seqs[idx]


def crc_compute_np(bits: np.ndarray, kind: str) -> np.ndarray:
    """Host-side CRC of an MSB-first bit vector (uint8). Returns L bits MSB-first."""
    B = crc_matrix(kind, int(bits.shape[-1]))
    r = (bits.astype(np.int64) @ B.astype(np.int64)) % 2
    L = crc_length(kind)
    # e_k bit t corresponds to coefficient of x^t; MSB-first output = reversed
    return r[..., ::-1].astype(np.uint8)[..., :L]


@lru_cache(maxsize=64)
def _crc_matrix_dev(kind: str, n_bits: int, device: torch.device) -> torch.Tensor:
    b = np.ascontiguousarray(crc_matrix(kind, n_bits)[:, ::-1])  # MSB-first cols
    return torch.as_tensor(b.astype(np.float32), device=device)


def crc_compute(bits: torch.Tensor, kind: str) -> torch.Tensor:
    """CRC parity bits [..., L] of bits [..., n] in {0,1}, same dtype."""
    b = _crc_matrix_dev(kind, int(bits.shape[-1]), bits.device)
    s = torch.matmul(bits.to(torch.float32), b)
    return torch.remainder(torch.round(s), 2.0).to(bits.dtype)


def crc_attach(bits: torch.Tensor, kind: str) -> torch.Tensor:
    """Append CRC parity bits: [..., n] -> [..., n+L]."""
    return torch.cat([bits, crc_compute(bits, kind)], dim=-1)


def crc_check(bits_with_crc: torch.Tensor, kind: str) -> torch.Tensor:
    """True where the CRC passes. bits_with_crc [..., n+L] -> bool [...]."""
    L = crc_length(kind)
    payload, rx_crc = bits_with_crc[..., :-L], bits_with_crc[..., -L:]
    return torch.all(rx_crc == crc_compute(payload, kind), dim=-1)


def crc_bitserial_reference(bits: np.ndarray, kind: str) -> np.ndarray:
    """Slow bit-serial long division — golden reference for tests only."""
    L, taps = CRC_POLYS[kind]
    g = np.zeros(L + 1, dtype=np.uint8)
    g[0] = 1  # x^L term, MSB-first
    for j in taps:
        g[L - j] = 1
    buf = np.concatenate([bits.astype(np.uint8), np.zeros(L, dtype=np.uint8)])
    for i in range(len(bits)):
        if buf[i]:
            buf[i : i + L + 1] ^= g
    return buf[-L:]
