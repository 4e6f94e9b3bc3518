"""Symbol modulation / soft demodulation / scrambling per TS 38.211 §5.1-5.2
(counterpart of isac_tpu/ops/modulation.py). Bit order is MSB-first per
modulation symbol.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

MODULATION_ORDERS = {"BPSK": 1, "QPSK": 2, "16QAM": 4, "64QAM": 6, "256QAM": 8}

_QAM_SCALE = {2: 1.0 / np.sqrt(2), 4: 1.0 / np.sqrt(10),
              6: 1.0 / np.sqrt(42), 8: 1.0 / np.sqrt(170)}


@lru_cache(maxsize=8)
def constellation(mod: str) -> np.ndarray:
    """Constellation points indexed by the MSB-first bit label (complex128 [2^Qm])."""
    qm = MODULATION_ORDERS[mod]
    labels = np.arange(1 << qm)
    bits = ((labels[:, None] >> (qm - 1 - np.arange(qm))[None, :]) & 1).astype(np.float64)
    if mod == "BPSK":  # 38.211 §5.1.2
        b = bits[:, 0]
        pts = ((1 - 2 * b) + 1j * (1 - 2 * b)) / np.sqrt(2)
    elif mod == "QPSK":  # §5.1.3
        pts = ((1 - 2 * bits[:, 0]) + 1j * (1 - 2 * bits[:, 1])) / np.sqrt(2)
    elif mod == "16QAM":  # §5.1.4
        i = (1 - 2 * bits[:, 0]) * (2 - (1 - 2 * bits[:, 2]))
        q = (1 - 2 * bits[:, 1]) * (2 - (1 - 2 * bits[:, 3]))
        pts = (i + 1j * q) / np.sqrt(10)
    elif mod == "64QAM":  # §5.1.5
        i = (1 - 2 * bits[:, 0]) * (4 - (1 - 2 * bits[:, 2]) * (2 - (1 - 2 * bits[:, 4])))
        q = (1 - 2 * bits[:, 1]) * (4 - (1 - 2 * bits[:, 3]) * (2 - (1 - 2 * bits[:, 5])))
        pts = (i + 1j * q) / np.sqrt(42)
    elif mod == "256QAM":  # §5.1.6
        i = (1 - 2 * bits[:, 0]) * (
            8 - (1 - 2 * bits[:, 2]) * (4 - (1 - 2 * bits[:, 4]) * (2 - (1 - 2 * bits[:, 6])))
        )
        q = (1 - 2 * bits[:, 1]) * (
            8 - (1 - 2 * bits[:, 3]) * (4 - (1 - 2 * bits[:, 5]) * (2 - (1 - 2 * bits[:, 7])))
        )
        pts = (i + 1j * q) / np.sqrt(170)
    else:
        raise ValueError(mod)
    return pts


def _level_np(s: np.ndarray, m: int) -> np.ndarray:
    if m == 1:
        return s[:, 0]
    t = 2.0 - s[:, m - 1]
    for j in range(m - 2, 0, -1):
        t = float(1 << (m - j)) - s[:, j] * t
    return s[:, 0] * t


def _axis_level(s: torch.Tensor) -> torch.Tensor:
    """Gray PAM level from sign planes s[..., m] (s = 1-2b, MSB first):
    level = s0*(2^(m-1) - s1*(2^(m-2) - ... - s_{m-1})) — the nested form of
    38.211 §5.1.3-§5.1.6, evaluated arithmetically (no table gather)."""
    m = s.shape[-1]
    if m == 1:
        return s[..., 0]
    t = 2.0 - s[..., m - 1]
    for j in range(m - 2, 0, -1):
        t = float(1 << (m - j)) - s[..., j] * t
    return s[..., 0] * t


def modulate(bits: torch.Tensor, mod: str, scramble: torch.Tensor | None = None) -> torch.Tensor:
    """bits [..., n*Qm] in {0,1} -> symbols [..., n] complex64.

    scramble: optional Gold sequence [..., n*Qm]; the XOR folds into the sign
    planes exactly ((1-2(b^c)) == (1-2b)(1-2c))."""
    qm = MODULATION_ORDERS[mod]
    *lead, nb = bits.shape
    if nb % qm:
        raise ValueError(f"{nb} bits not a multiple of Qm={qm}")
    s = 1.0 - 2.0 * bits.reshape(*lead, nb // qm, qm).to(torch.float32)
    if scramble is not None:
        sc = scramble.reshape(*scramble.shape[:-1], nb // qm, qm).to(torch.float32)
        s = s * (1.0 - 2.0 * sc)
    if mod == "BPSK":  # §5.1.2: both axes carry the single bit
        lvl = s[..., 0] * np.float32(1.0 / np.sqrt(2))
        return torch.complex(lvl, lvl)
    scale = float(np.float32(_QAM_SCALE[qm]))
    return torch.complex(_axis_level(s[..., 0::2]) * scale,
                         _axis_level(s[..., 1::2]) * scale)


@lru_cache(maxsize=8)
def _axis_levels(qm: int):
    """All 2^(Qm/2) PAM levels of one axis + their bit labels (MSB first).
    Returns (levels [L] f32 — already 1/sqrt(norm) scaled, labels [L, m])."""
    m = qm // 2
    combos = np.arange(1 << m)
    bits = ((combos[:, None] >> (m - 1 - np.arange(m))[None, :]) & 1).astype(np.float64)
    lvl = _level_np(1.0 - 2.0 * bits, m)
    return (lvl * _QAM_SCALE[qm]).astype(np.float32), bits.astype(np.float32)


def _gray_axis_llr_closed(t: torch.Tensor, m: int) -> torch.Tensor:
    """Exact max-log LLRs for one Gray-PAM axis in closed form.

    t: observation in unscaled level units (levels are the odd integers
    +-1..+-(2^m-1)); returns [..., m], positive for bit 0. Per stage the
    sign-bit max-log value is (t+1)^2 - (t-p)^2 with p the nearest positive
    odd level = clip(2*floor(|t|/2)+1, 1, 2D-1), extended by odd symmetry;
    the Gray fold t <- D - |t| recurses to the next bit. Equal to the
    masked-min form of demodulate_llr; kept as the reference algebra, not
    used on the receive path."""
    outs = []
    d = float(1 << (m - 1))
    for _ in range(m):
        a = torch.abs(t)
        if d == 1.0:
            outs.append(4.0 * t)  # single level +-1: (t+1)^2-(t-1)^2
        else:
            p = torch.clamp(2.0 * torch.floor(a / 2.0) + 1.0, 1.0, 2.0 * d - 1.0)
            lmag = 2.0 * a * (1.0 + p) + 1.0 - p * p
            outs.append(torch.sign(t) * lmag)
        t = d - a
        d /= 2.0
    return torch.stack(outs, dim=-1)


def demodulate_llr(symbols: torch.Tensor, noise_var, mod: str) -> torch.Tensor:
    """Max-log LLRs, positive for bit=0. symbols [..., n], noise_var
    broadcastable to symbols -> llr [..., n*Qm].

    Masked-min per-axis form of the reference: for square Gray QAM each bit
    depends on one axis only, so the LLR is a min over that axis's levels
    with 1e30 sentinels where the label does not match."""
    qm = MODULATION_ORDERS[mod]
    dev = symbols.device
    if mod == "BPSK":
        pts = torch.as_tensor(constellation(mod).astype(np.complex64), device=dev)
        d2 = torch.abs(symbols[..., None] - pts) ** 2
        llr = (d2[..., 1] - d2[..., 0])[..., None]
    else:
        levels, labels = _axis_levels(qm)
        lv = torch.as_tensor(levels, device=dev)
        big = torch.tensor(1e30, dtype=torch.float32, device=dev)
        di = (symbols.real[..., None] - lv) ** 2  # [..., n, L]
        dq = (symbols.imag[..., None] - lv) ** 2
        per_bit = []
        for j in range(qm // 2):
            mask1 = torch.as_tensor(labels[:, j] == 1, device=dev)
            for d in (di, dq):  # bit 2j from I, bit 2j+1 from Q
                d0 = torch.amin(torch.where(mask1, big, d), dim=-1)
                d1 = torch.amin(torch.where(mask1, d, big), dim=-1)
                per_bit.append(d1 - d0)
        llr = torch.stack(per_bit, dim=-1)  # [..., n, Qm]
    nv = torch.clamp_min(torch.as_tensor(noise_var, dtype=llr.dtype, device=dev), 1e-10)
    llr = llr / nv.expand(symbols.shape)[..., None]
    return llr.reshape(*symbols.shape[:-1], symbols.shape[-1] * qm)


def scramble_bits(bits: torch.Tensor, c_seq) -> torch.Tensor:
    """b XOR c. c_seq: precomputed Gold sequence (same length), tensor or numpy."""
    c = torch.as_tensor(c_seq, device=bits.device).to(torch.int32)
    return torch.bitwise_xor(bits.to(torch.int32), c).to(bits.dtype)


def descramble_llr(llr: torch.Tensor, c_seq: torch.Tensor) -> torch.Tensor:
    """Soft descrambling: flip the LLR sign where c=1."""
    return llr * (1.0 - 2.0 * c_seq.to(llr.dtype))


def pdsch_scrambling_cinit(rnti: int, q: int, n_id: int) -> int:
    """TS 38.211 §7.3.1.1: c_init = rnti*2^15 + q*2^14 + n_id."""
    return (rnti << 15) + (q << 14) + n_id


def pusch_scrambling_cinit(rnti: int, n_id: int) -> int:
    """TS 38.211 §6.3.1.1 (non-UCI): c_init = rnti*2^15 + n_id."""
    return (rnti << 15) + n_id


def hard_decision(llr: torch.Tensor) -> torch.Tensor:
    """LLR > 0 => bit 0 (positive-for-zero convention)."""
    return (llr < 0).to(torch.int8)
