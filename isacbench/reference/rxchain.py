"""The receiver's stages after the channel estimate, in plain float64 NumPy
and PyTorch, from the standards:

- DM-RS base sequence (TS 38.211 §7.4.1.1.1, configuration type 1,
  CRB-0 referenced): r(m) = ((1 - 2c(2m)) + j(1 - 2c(2m+1))) / sqrt(2) with
  c_init = (2^17 (14 n_s + l + 1)(2 N_ID + 1) + 2 N_ID) mod 2^31;
- Gold sequence (§5.2.1): x1 from 1, x2 from c_init, N_c = 1600;
- MMSE with bias removal per resource element: A = H^H H + s2 I,
  x = A^-1 H^H y, mu_l = 1 - s2 [A^-1]_ll, symbol x / mu, SINR mu / (1 - mu);
- max-log demapping of the square Gray QAM of §5.1 (each bit follows one
  axis), positive for bit 0, over the noise variance 1 / SINR;
- layer demapping (§7.3.1.3: codeword symbol i on layer i mod L), soft
  descrambling with the Gold sequence of c_init = n_RNTI 2^15 (+ q 2^14)
  + n_ID (§7.3.1.1, §6.3.1.1), LLRs clipped to +-60;
- rate recovery (TS 38.212 §5.4.2): per-code-block lengths E_r, bit
  deinterleaving over Q_m rows, bit selection from k0 of the redundancy
  version over the circular buffer without its filler bits, repetitions and
  the HARQ soft buffer added, filler bits set to a large bit-0 LLR, the 2Z
  punctured bits zero;
- parity check of the lifted code and CRC checks (§5.1: CRC24A, CRC24B,
  CRC16) of the hard decisions, and the transport block they give.
"""

from __future__ import annotations

import numpy as np
import torch

from isacbench.reference import ldpc

_NC = 1600
POLY = {"24A": (24, 0x1864CFB), "24B": (24, 0x1800063), "16": (16, 0x11021)}
K0 = {1: (0, 17, 33, 56), 2: (0, 13, 25, 43)}


def gold(c_init: int, length: int) -> np.ndarray:
    n = _NC + length
    x1 = np.zeros(n + 59, np.uint8)
    x2 = np.zeros(n + 59, np.uint8)
    x1[0] = 1
    x2[:31] = [(c_init >> i) & 1 for i in range(31)]
    for i in range(0, n, 28):  # x(i + 31) needs x(i + 3) at the latest: 28 at a time
        x1[i + 31:i + 59] = x1[i + 3:i + 31] ^ x1[i:i + 28]
        x2[i + 31:i + 59] = x2[i + 3:i + 31] ^ x2[i + 2:i + 30] ^ x2[i + 1:i + 29] ^ x2[i:i + 28]
    return x1[_NC:_NC + length] ^ x2[_NC:_NC + length]


def dmrs_base(slot: int, symbol: int, n_id: int, prbs) -> np.ndarray:
    """r(m) over the PRBs `prbs`, 6 values each, referenced to CRB 0."""
    c_init = ((1 << 17) * (14 * slot + symbol + 1) * (2 * n_id + 1) + 2 * n_id) % (1 << 31)
    top = max(prbs) + 1
    c = gold(c_init, 12 * top).astype(np.float64)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2.0)
    return np.concatenate([r[6 * p:6 * p + 6] for p in prbs])


def scrambling(rnti: int, n_id: int, length: int) -> np.ndarray:
    """PDSCH with one codeword (q = 0) and PUSCH share c_init = n_RNTI 2^15 + n_ID."""
    return gold((rnti << 15) + n_id, length)


def mmse(y: torch.Tensor, h: torch.Tensor, s2: torch.Tensor):
    """y [N, rx, S, K], h [N, S, K, rx, L], s2 [N] -> (symbols, SINR), each
    [N, L, S, K], float64."""
    y = y.to(torch.complex128).permute(0, 2, 3, 1)[..., None]  # [N, S, K, rx, 1]
    h = h.to(torch.complex128)
    hh = h.conj().transpose(-1, -2)
    n_l = h.shape[-1]
    s2 = s2.to(torch.float64)[:, None, None, None, None]
    a = hh @ h + s2 * torch.eye(n_l, dtype=torch.complex128, device=h.device)
    a_inv = torch.linalg.inv(a)
    x = (a_inv @ (hh @ y))[..., 0]
    q = torch.clamp(s2[..., 0] * torch.diagonal(a_inv, dim1=-2, dim2=-1).real, 1e-6, 1 - 1e-6)
    mu = 1.0 - q
    return (x / mu).permute(0, 3, 1, 2), (mu / q).permute(0, 3, 1, 2)


def data_res(n_prb: int, sym_start: int, n_sym: int, dmrs_syms, reserved) -> tuple:
    """(symbol, subcarrier) of the data resource elements of an allocation
    of n_prb PRBs, symbol by symbol: the scheduled symbols, none on a DM-RS
    symbol (no data beside DM-RS of two CDM groups), none on a reserved
    (symbol, subcarrier in PRB) such as the CSI-RS."""
    alloc = np.zeros((14, 12 * n_prb), bool)
    alloc[sym_start:sym_start + n_sym] = True
    alloc[list(dmrs_syms)] = False
    for sym, off in reserved:
        alloc[sym, off::12] = False
    return np.nonzero(alloc)


def axis_levels(qm: int):
    """The levels of one axis and the bits (a_0 .. a_m-1: b0, b2, ... on I,
    b1, b3, ... on Q) each carries: (1 - 2 a_0) v_1 with v_m = 1 and
    v_i = 2^(m-i) - (1 - 2 a_i) v_(i+1), over sqrt(2, 10, 42, 170)."""
    m = qm // 2
    bits = np.array([[(v >> (m - 1 - i)) & 1 for i in range(m)] for v in range(2**m)])
    levels = np.zeros(2**m)
    for v, a in enumerate(bits):
        t = 1.0
        for i in range(m - 1, 0, -1):
            t = 2.0 ** (m - i) - (1 - 2 * a[i]) * t
        levels[v] = (1 - 2 * a[0]) * t
    return levels / np.sqrt({1: 2, 2: 10, 3: 42, 4: 170}[m]), bits


def demap(sym: torch.Tensor, noise_var: torch.Tensor, qm: int) -> torch.Tensor:
    """Max-log LLRs [..., n * qm] (positive for bit 0) of symbols [..., n]."""
    levels, bits = axis_levels(qm)
    lv = torch.as_tensor(levels, dtype=torch.float64, device=sym.device)
    sym = sym.to(torch.complex128)
    per_axis = []
    for x in (sym.real, sym.imag):
        d = (x[..., None] - lv) ** 2
        per_axis.append([
            torch.amin(d[..., bits[:, i] == 1], dim=-1) - torch.amin(d[..., bits[:, i] == 0], dim=-1)
            for i in range(qm // 2)])
    order = [per_axis[k % 2][k // 2] for k in range(qm)]  # b0 (I), b1 (Q), b2 (I), ...
    llr = torch.stack(order, dim=-1) / noise_var.to(torch.float64)[..., None]
    return llr.reshape(*sym.shape[:-1], -1)


def layer_demap(llr: torch.Tensor, n_layers: int, qm: int) -> torch.Tensor:
    """[N, L * n * qm] layer by layer -> codeword order: symbol i of the
    codeword is symbol i // L of layer i mod L."""
    n = llr.shape[0]
    return llr.reshape(n, n_layers, -1, qm).transpose(1, 2).reshape(n, -1)


def e_per_cb(g: int, c: int, qm: int, n_layers: int) -> list:
    """TS 38.212 §5.4.2.1 rate-matched length of each code block."""
    unit = n_layers * qm
    return [unit * (g // (unit * c)) if r <= c - ((g // unit) % c) - 1
            else unit * -(-g // (unit * c)) for r in range(c)]


def rate_recover(llr_e: np.ndarray, bg: int, z: int, k: int, n_filler: int, qm: int, rv: int,
                 soft: np.ndarray | None, filler_llr: float = 1e4):
    """One code block: received LLRs [E] -> (decoder input [n_cols * z],
    circular buffer [N_cb]), in float32 with repetitions summed in order."""
    e = llr_e.shape[0]
    deint = llr_e.reshape(e // qm, qm).T.reshape(e)  # e_k from f
    n_cb = (66 if bg == 1 else 50) * z
    k0 = (K0[bg][rv] * n_cb // ((66 if bg == 1 else 50) * z)) * z
    is_filler = np.zeros(n_cb, bool)
    is_filler[k - n_filler - 2 * z:k - 2 * z] = True
    order = np.roll(np.arange(n_cb), -k0)
    order = order[~is_filler[order]]
    buf = np.zeros(n_cb, np.float32)
    pos = np.resize(order, e)
    for start in range(0, e, order.size):  # one pass per repetition, in order
        chunk = slice(start, min(start + order.size, e))
        buf[pos[chunk]] += deint[chunk]
    if soft is not None:
        buf = buf + soft.astype(np.float32)
    buf[is_filler] = np.float32(filler_llr)
    return np.concatenate([np.zeros(2 * z, np.float32), buf]), buf


def parity_ok(hard: np.ndarray, bg: int, z: int) -> np.ndarray:
    """[B, n_cols * z] hard bits -> every check of the lifted code satisfied [B]."""
    lane = np.arange(z)
    ok = np.ones(hard.shape[0], bool)
    for cols, shifts in ldpc.row_edges(bg, z):
        idx = (cols[:, None] * z + (lane[None, :] + shifts[:, None]) % z).reshape(-1)
        par = np.bitwise_xor.reduce(hard[:, idx].reshape(hard.shape[0], len(cols), z), axis=1)
        ok &= ~par.any(axis=1)
    return ok


def crc_ok(bits: np.ndarray, kind: str) -> np.ndarray:
    """[B, n] bits with their CRC last -> the remainder is zero [B]."""
    width, poly = POLY[kind]
    low = poly & ((1 << width) - 1)
    state = np.zeros(bits.shape[0], np.int64)
    for col in range(bits.shape[1]):
        top = (state >> (width - 1)) & 1
        state = ((state << 1) & ((1 << width) - 1)) | bits[:, col].astype(np.int64)
        state ^= np.where(top == 1, low, 0)
    return state == 0


def transport_block(post: np.ndarray, cfg) -> tuple:
    """Posterior LLRs [N, C, n_cols * z] of one grant batch -> (transport
    blocks [N, A], CRC passed [N]): hard decisions, the code's parity, the
    code blocks' CRC24B when there are several, the transport block's CRC."""
    n, c = post.shape[:2]
    hard = (post < 0).astype(np.uint8)
    ok = parity_ok(hard.reshape(n * c, -1), cfg.bg, cfg.z).reshape(n, c)
    cbs = hard[..., :cfg.k_prime]
    if cfg.cb_crc:
        ok &= crc_ok(cbs.reshape(n * c, -1), "24B").reshape(n, c)
        cbs = cbs[..., :-24]
    b = cbs.reshape(n, -1)
    width = POLY[cfg.tb_crc][0]
    tb_ok = crc_ok(b[:, :cfg.a + width], cfg.tb_crc) & ok.all(axis=1)
    return b[:, :cfg.a], tb_ok
