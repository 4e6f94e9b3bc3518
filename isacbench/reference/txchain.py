"""The transmitter of a grant, in plain float64 NumPy, from the standards:

- transport-block CRC (TS 38.212 §5.1: CRC16 up to 3824 bits, CRC24A above),
  base graph (§7.2.2: BG2 for A <= 292, for A <= 3824 at R <= 0.67, and for
  R <= 0.25), code-block segmentation (§5.2.2: CRC24B on each of several
  blocks, K_b, the least lifting size Z with K_b Z >= K', filler bits);
- LDPC encoding (§5.3.2) of the lifted base graph: the codeword c satisfies
  H c = 0; its first K bits are the block; the four core parity groups solve
  the first four rows (a dense GF(2) inverse of the lifted core), and each
  extension parity group follows from its own row;
- rate matching (§5.4.2) over the full circular buffer without the 2Z
  punctured bits: bit selection from k0 of the redundancy version, filler
  bits skipped, then bit interleaving over Q_m rows;
- scrambling (TS 38.211 §7.3.1.1 / §6.3.1.1), Gray QAM mapping (§5.1) at unit
  mean power, layer mapping (§7.3.1.3);
- DM-RS of configuration type 1 (§7.4.1.1.2): ports (0, 2, 1, 3) by rank,
  comb offset port // 2, frequency OCC (-1)^k' on odd ports, at the data's
  power, on mapping-type-A positions clamped to the scheduled symbols (the
  additional position moves in for short durations; a duration holding none
  gets one at its first symbol); no data on a DM-RS symbol;
- precoding of every resource element (PDSCH: one matrix per pair of
  allocated PRBs; PUSCH: one wideband matrix) and placement of the
  allocation's PRBs on the carrier.

What the reference takes as the scheduler's grant: the PRBs, symbols, rank,
redundancy version, modulation order and target code rate of the MCS, the
reserved resource elements (the CSI-RS) and the precoding matrices.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from isacbench.reference import ldpc, rxchain

_LIFT_A = (2, 3, 5, 7, 9, 11, 13, 15)
LIFT_SIZES = tuple(sorted({a * 2**j for a in _LIFT_A for j in range(8) if a * 2**j <= 384}))
KB_INFO = {1: 22, 2: 10}  # information columns of the base graph
QAM_NORM = {2: 2.0, 4: 10.0, 6: 42.0, 8: 170.0}


def dmrs_symbols(add_pos: int, sym_start: int, n_sym: int) -> tuple:
    end = sym_start + n_sym
    if add_pos == 0:
        base = (2,)
    elif add_pos == 1:
        base = (2, 11 if end >= 13 else (9 if end >= 11 else 7))
    elif add_pos == 2:
        base = (2, 7, 11) if end >= 13 else (2, 6, 9)
    else:
        base = (2, 5, 8, 11)
    out = tuple(s for s in base if sym_start <= s < end)
    return out if out else (sym_start,)


def crc_bits(msg: np.ndarray, kind: str) -> np.ndarray:
    """[B, n] bits -> their CRC [B, width], the remainder of msg(x) x^width
    modulo the generator, most significant bit first."""
    width, poly = rxchain.POLY[kind]
    mask = (1 << width) - 1
    low = poly & mask
    b, n = msg.shape
    state = np.zeros(b, np.int64)
    head = n % 8
    for col in range(head):  # bit by bit up to a byte boundary
        top = ((state >> (width - 1)) & 1) ^ msg[:, col].astype(np.int64)
        state = (state << 1) & mask
        state ^= np.where(top == 1, low, 0)
    table = _crc_table(kind)
    packed = np.packbits(msg[:, head:].astype(np.uint8), axis=1).astype(np.int64)
    for col in range(packed.shape[1]):
        idx = ((state >> (width - 8)) ^ packed[:, col]) & 0xFF
        state = ((state << 8) & mask) ^ table[idx]
    return ((state[:, None] >> np.arange(width - 1, -1, -1)[None, :]) & 1).astype(np.uint8)


@lru_cache(maxsize=None)
def _crc_table(kind: str) -> np.ndarray:
    width, poly = rxchain.POLY[kind]
    mask = (1 << width) - 1
    out = np.zeros(256, np.int64)
    for i in range(256):
        s = i << (width - 8)
        for _ in range(8):
            s = ((s << 1) ^ poly) & mask if s >> (width - 1) & 1 else (s << 1) & mask
        out[i] = s
    return out


def segment(a: int, rate: float) -> dict:
    """The segmentation of an A-bit transport block at target rate R."""
    bg = 2 if (a <= 292 or (a <= 3824 and rate <= 0.67) or rate <= 0.25) else 1
    tb_crc = "16" if a <= 3824 else "24A"
    b = a + rxchain.POLY[tb_crc][0]
    kcb = 8448 if bg == 1 else 3840
    if b <= kcb:
        c, l_cb = 1, 0
    else:
        c, l_cb = -(-b // (kcb - 24)), 24
    k_prime = -(-(b + c * l_cb) // c)
    if bg == 1:
        kb = 22
    else:
        kb = 10 if b > 640 else 9 if b > 560 else 8 if b > 192 else 6
    z = min(zz for zz in LIFT_SIZES if kb * zz >= k_prime)
    return {"a": a, "bg": bg, "tb_crc": tb_crc, "c": c, "l_cb": l_cb, "k_prime": k_prime,
            "z": z, "k": KB_INFO[bg] * z}


@lru_cache(maxsize=32)
def _encoder(bg: int, z: int):
    """(row edges, the GF(2) inverse of the lifted core [4z, 4z]) of BG `bg`
    lifted by z."""
    kb = KB_INFO[bg]
    rows = ldpc.row_edges(bg, z)
    lane = np.arange(z)
    core = np.zeros((4 * z, 4 * z), np.uint8)
    for r in range(4):
        for col, s in zip(*rows[r]):
            if kb <= col < kb + 4:
                core[r * z + lane, (col - kb) * z + (lane + s) % z] ^= 1
    for r in range(4, len(rows)):
        ext = [(col, s) for col, s in zip(*rows[r]) if col >= kb + 4]
        assert ext == [(kb + r, 0)], (bg, r, ext)  # the extension is an identity
    return rows, _gf2_inverse(core)


def _gf2_inverse(m: np.ndarray) -> np.ndarray:
    """The inverse of a square GF(2) matrix, by Gauss-Jordan elimination on
    rows packed eight bits to the byte."""
    n = m.shape[0]
    aug = np.packbits(np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1),
                      axis=1)
    for col in range(n):
        byte, bit = col // 8, 7 - col % 8
        colbits = (aug[:, byte] >> bit) & 1
        below = np.nonzero(colbits[col:])[0]
        if below.size == 0:
            raise ValueError("the lifted core is singular")
        pivot = col + int(below[0])
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
            colbits[[col, pivot]] = colbits[[pivot, col]]
        colbits[col] = 0
        aug[colbits == 1] ^= aug[col]
    return np.unpackbits(aug, axis=1)[:, n:2 * n]


def ldpc_encode(blocks: np.ndarray, bg: int, z: int) -> np.ndarray:
    """Code blocks [B, K] (filler bits 0) -> codewords [B, n_cols z]."""
    kb = KB_INFO[bg]
    rows, core_inv = _encoder(bg, z)
    n_cols = ldpc.SHAPES[bg][1]
    b = blocks.shape[0]
    cw = np.zeros((b, n_cols, z), np.uint8)
    cw[:, :kb] = blocks.reshape(b, kb, z)
    lane = np.arange(z)

    def row_sum(r, cols_limit):
        acc = np.zeros((b, z), np.uint8)
        for col, s in zip(*rows[r]):
            if col < cols_limit:
                acc ^= cw[:, col, (lane + s) % z]
        return acc

    lam = np.concatenate([row_sum(r, kb) for r in range(4)], axis=1)  # [B, 4z]
    core = (lam.astype(np.float64) @ core_inv.T.astype(np.float64)).astype(np.int64) % 2
    cw[:, kb:kb + 4] = core.reshape(b, 4, z)
    for r in range(4, len(rows)):
        cw[:, kb + r] = row_sum(r, kb + 4)
    return cw.reshape(b, -1)


def rate_match(cw: np.ndarray, bg: int, z: int, k: int, k_prime: int, rv: int, e: int,
               qm: int) -> np.ndarray:
    """One codeword [n_cols z] -> its E rate-matched, interleaved bits."""
    n_cb = (66 if bg == 1 else 50) * z
    buf = cw[2 * z:]
    k0 = rxchain.K0[bg][rv] * z
    filler = np.zeros(n_cb, bool)
    filler[k_prime - 2 * z:k - 2 * z] = True
    order = np.roll(np.arange(n_cb), -k0)
    order = order[~filler[order]]
    bits = buf[np.resize(order, e)]
    return bits.reshape(qm, e // qm).T.reshape(e)


def codeword_bits(tb: np.ndarray, rate: float, qm: int, n_layers: int, g: int,
                  rv: int) -> np.ndarray:
    """Transport block [A] -> the G coded, rate-matched bits of the grant."""
    seg = segment(int(tb.shape[0]), rate)
    c, l_cb, kp, k, z, bg = seg["c"], seg["l_cb"], seg["k_prime"], seg["k"], seg["z"], seg["bg"]
    b = np.concatenate([tb.astype(np.uint8), crc_bits(tb[None].astype(np.uint8),
                                                      seg["tb_crc"])[0]])
    per = kp - l_cb
    b = np.concatenate([b, np.zeros(c * per - b.shape[0], np.uint8)])
    blocks = np.zeros((c, k), np.uint8)
    data = b.reshape(c, per)
    blocks[:, :per] = data
    if l_cb:
        blocks[:, per:kp] = crc_bits(data, "24B")
    cws = ldpc_encode(blocks, bg, z)
    es = rxchain.e_per_cb(g, c, qm, n_layers)
    return np.concatenate([rate_match(cws[r], bg, z, k, kp, rv, es[r], qm) for r in range(c)])


def qam(bits: np.ndarray, qm: int) -> np.ndarray:
    """Gray QAM (TS 38.211 §5.1): bits b0 b2 .. on the real axis, b1 b3 .. on
    the imaginary one, unit mean power."""
    m = qm // 2
    b = bits.reshape(-1, qm).astype(np.float64)

    def axis(cols):
        t = np.ones(b.shape[0])
        for i in range(m - 1, 0, -1):
            t = 2.0 ** (m - i) - (1 - 2 * b[:, cols[i]]) * t
        return (1 - 2 * b[:, cols[0]]) * t

    return (axis(list(range(0, qm, 2))) + 1j * axis(list(range(1, qm, 2)))) / np.sqrt(QAM_NORM[qm])


def port_grid(tb: np.ndarray, g: dict, w: np.ndarray, n_sc_grid: int) -> np.ndarray:
    """One grant's port grid [P, 14, n_sc_grid] (complex128) from its
    transport block [A], grant `g` and precoder `w` ([n_prg, P, L] for
    PDSCH, [P, L] for PUSCH)."""
    prbs = np.asarray(g["prbs"], np.int64)
    n_prb, n_l, qm = len(prbs), g["n_layers"], g["qm"]
    dsyms = dmrs_symbols(g["add_pos"], g["sym_start"], g["n_sym"])
    sym, sc = rxchain.data_res(n_prb, g["sym_start"], g["n_sym"], dsyms, g["reserved"])
    g_bits = sym.size * qm * n_l
    bits = codeword_bits(tb, g["rate"], qm, n_l, g_bits, g["rv"])
    bits = bits ^ rxchain.scrambling(g["rnti"], g["n_id"], g_bits)
    d = qam(bits, qm)
    layers = d.reshape(-1, n_l).T  # symbol i on layer i mod L
    lg = np.zeros((n_l, 14, 12 * n_prb), np.complex128)
    lg[:, sym, sc] = layers
    m = np.arange(6 * n_prb)
    for layer, port in enumerate((0, 2, 1, 3)[:n_l]):
        occ = (-1.0) ** (m % 2) if port % 2 else np.ones(m.size)
        for s in dsyms:
            lg[layer, s, 2 * m + port // 2] = rxchain.dmrs_base(g["slot"], s, g["n_id"], prbs) * occ
    w = np.asarray(w, np.complex128)
    if w.ndim == 2:
        pg = np.einsum("pl,lsk->psk", w, lg)
    else:
        w_sc = w[np.minimum(np.arange(12 * n_prb) // 24, w.shape[0] - 1)]  # [K, P, L]
        pg = np.einsum("kpl,lsk->psk", w_sc, lg)
    out = np.zeros((pg.shape[0], 14, n_sc_grid), np.complex128)
    out[..., (12 * prbs[:, None] + np.arange(12)).reshape(-1)] = pg
    return out
