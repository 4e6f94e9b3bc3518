"""QC-LDPC per TS 38.212 §5.3.2: lifted codes, encoding, parity check and
rate matching (counterpart of isac_tpu/ops/ldpc.py).

This is the reference's CPU formulation: the cyclic Z-shifts are precomputed
gathers and every per-row XOR sum is a one-hot [rows, edges] float32 product
taken mod 2 (exact: the sums are small integers). The reference's TPU-only
static-roll branch (``_use_static_rolls``) gives the same bits and is not
ported. Layered decoding lives in ldpc_layered.py; the flooding decoder is
not ported yet.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

# TS 38.212 Table 5.3.2-1: Z = a * 2^j, set index iLS by a
_LIFT_SETS = {2: 0, 3: 1, 5: 2, 7: 3, 9: 4, 11: 5, 13: 6, 15: 7}
LIFTING_SIZES = sorted(
    {a * (1 << j) for a in _LIFT_SETS for j in range(8) if a * (1 << j) <= 384}
)


def lifting_set_index(z: int) -> int:
    a = z
    while a % 2 == 0 and a not in _LIFT_SETS:  # powers of two resolve to a=2
        a //= 2
    return _LIFT_SETS[a]


def select_base_graph(a_bits: int, rate: float) -> int:
    """§7.2.2: BG2 if A<=292, or (A<=3824 and R<=0.67), or R<=0.25; else BG1."""
    if a_bits <= 292 or (a_bits <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


def kb_for(bg: int, b_bits: int) -> int:
    """§5.2.2: Kb = 22 (BG1); BG2: 10/9/8/6 by payload size."""
    if bg == 1:
        return 22
    if b_bits > 640:
        return 10
    if b_bits > 560:
        return 9
    if b_bits > 192:
        return 8
    return 6


def select_lifting_size(kb: int, k_prime: int) -> int:
    """Smallest Z in the table with Kb*Z >= K'."""
    for z in LIFTING_SIZES:
        if kb * z >= k_prime:
            return z
    raise ValueError(f"K'={k_prime} too large for Kb={kb}")


@dataclass(frozen=True, eq=False)
class LiftedCode:
    """Base graph expanded at lifting size Z (shift = V mod Z); edges are in
    row-major order of the base graph."""

    bg: int
    z: int
    k: int  # 22Z / 10Z
    n_full: int  # 68Z / 52Z (incl. punctured 2Z)
    rows: np.ndarray  # [E] check-block row per edge
    cols: np.ndarray  # [E] variable-block col per edge
    shifts: np.ndarray  # [E] cyclic shift
    n_rows: int
    n_cols: int
    k_cols: int


@lru_cache(maxsize=32)
def lifted_code(bg: int, z: int) -> LiftedCode:
    from isac_tpu_torch.ops import ldpc_tables

    n_rows, n_cols, k_cols = (46, 68, 22) if bg == 1 else (42, 52, 10)
    ils = lifting_set_index(z)
    ent = ldpc_tables.build_entries(bg)
    return LiftedCode(
        bg=bg,
        z=z,
        k=k_cols * z,
        n_full=n_cols * z,
        rows=np.asarray([r for r, _, _ in ent], np.int32),
        cols=np.asarray([c for _, c, _ in ent], np.int32),
        shifts=np.asarray([s[ils] % z for _, _, s in ent], np.int32),
        n_rows=n_rows,
        n_cols=n_cols,
        k_cols=k_cols,
    )


def _shift_idx(shifts: np.ndarray, z: int) -> np.ndarray:
    """[E, Z] gather index (i + s) % z: (P^s v)[i] = v[(i+s) mod Z]."""
    return ((np.arange(z)[None, :] + shifts[:, None]) % z).astype(np.int64)


def _gather_shift(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., E, Z], idx [E, Z] -> x[..., e, idx[e, i]]."""
    return torch.gather(x, -1, idx.expand(*x.shape[:-2], *idx.shape))


def _pshift(v: torch.Tensor, s: int) -> torch.Tensor:
    return torch.roll(v, -s, dims=-1)


@lru_cache(maxsize=32)
def _encode_plan(bg: int, z: int):
    """Host plan of the batched encoder: systematic edges as one gather plus a
    one-hot row sum, core-parity taps of the extension rows likewise, and the
    parity-core recipe derived from the loaded table (row-sum trick with the
    single odd-multiplicity p1 shift)."""
    code = lifted_code(bg, z)
    kc = code.k_cols
    sys = np.nonzero(code.cols < kc)[0]
    sys_oneh = np.zeros((code.n_rows, sys.shape[0]), np.float32)
    sys_oneh[code.rows[sys], np.arange(sys.shape[0])] = 1.0
    tap = np.nonzero((code.cols >= kc) & (code.cols < kc + 4) & (code.rows >= 4))[0]
    tap_oneh = np.zeros((code.n_rows - 4, tap.shape[0]), np.float32)
    tap_oneh[code.rows[tap] - 4, np.arange(tap.shape[0])] = 1.0
    core_par = [[None] * 4 for _ in range(4)]
    core = np.nonzero((code.cols >= kc) & (code.cols < kc + 4) & (code.rows < 4))[0]
    for e in core:
        core_par[int(code.rows[e])][int(code.cols[e]) - kc] = int(code.shifts[e])
    p1_shifts = [core_par[r][0] for r in range(4) if core_par[r][0] is not None]
    odd = [s for s, n in Counter(p1_shifts).items() if n % 2 == 1]
    if len(odd) != 1:
        raise ValueError(f"non-encodable parity core bg={bg} z={z}: {p1_shifts}")
    arrays = {
        "sys_cols": code.cols[sys].astype(np.int64),
        "sys_idx": _shift_idx(code.shifts[sys], z),
        "sys_oneh": sys_oneh,
        "tap_cols": (code.cols[tap] - kc).astype(np.int64),
        "tap_idx": _shift_idx(code.shifts[tap], z),
        "tap_oneh": tap_oneh,
    }
    return code, arrays, tuple(map(tuple, core_par)), odd[0]


@lru_cache(maxsize=64)
def _encode_tensors(bg: int, z: int, device: torch.device) -> dict:
    _, arrays, _, _ = _encode_plan(bg, z)
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def encode(code: LiftedCode, msg: torch.Tensor) -> torch.Tensor:
    """Systematic QC-LDPC encode. msg [..., K] in {0,1} -> codeword
    [..., n_full] int8 (core parities by the row-sum trick, extension
    parities direct)."""
    code, _, core_par, p1_surv = _encode_plan(code.bg, code.z)
    t = _encode_tensors(code.bg, code.z, msg.device)
    lead = msg.shape[:-1]
    z, kc = code.z, code.k_cols
    m = msg.reshape(*lead, kc, z).to(torch.float32)
    m_e = _gather_shift(m[..., t["sys_cols"], :], t["sys_idx"])  # [..., Es, Z]
    lam = torch.remainder(torch.matmul(t["sys_oneh"], m_e), 2.0)  # [..., rows, Z]
    s_all = torch.remainder(lam[..., 0, :] + lam[..., 1, :] + lam[..., 2, :]
                            + lam[..., 3, :], 2.0)
    p1 = _pshift(s_all, -p1_surv)
    p = [p1, None, None, None]
    for j in range(3):  # rows 0..2 give p2..p4 by back-substitution
        acc = lam[..., j, :]
        if core_par[j][0] is not None:
            acc = acc + _pshift(p1, core_par[j][0])
        for i in range(1, j + 1):
            if core_par[j][i] is not None:
                acc = acc + p[i]
        p[j + 1] = torch.remainder(acc, 2.0)
    p_core = torch.stack(p, dim=-2)  # [..., 4, Z]
    if t["tap_cols"].shape[0]:
        t_e = _gather_shift(p_core[..., t["tap_cols"], :], t["tap_idx"])
        taps = torch.matmul(t["tap_oneh"], t_e)
    else:
        taps = 0.0
    p_ext = torch.remainder(lam[..., 4:, :] + taps, 2.0)
    out = torch.cat(
        [m.reshape(*lead, -1), p_core.reshape(*lead, -1), p_ext.reshape(*lead, -1)],
        dim=-1,
    )
    return out.to(torch.int8)


@lru_cache(maxsize=64)
def _parity_tensors(bg: int, z: int, device: torch.device):
    code = lifted_code(bg, z)
    e_count = code.rows.shape[0]
    row_oneh = np.zeros((code.n_rows, e_count), np.float32)
    row_oneh[code.rows, np.arange(e_count)] = 1.0
    return (
        torch.as_tensor(code.cols.astype(np.int64), device=device),
        torch.as_tensor(_shift_idx(code.shifts, z), device=device),
        torch.as_tensor(row_oneh, device=device),
    )


def parity_check(hard_full: torch.Tensor, bg: int, z: int) -> torch.Tensor:
    """Hard bits [..., n_cols*z] -> all-check-equations-satisfied bool [...]."""
    code = lifted_code(bg, z)
    cols, fwd_idx, row_oneh = _parity_tensors(bg, z, hard_full.device)
    b = hard_full.reshape(*hard_full.shape[:-1], code.n_cols, z).to(torch.float32)
    bits_e = _gather_shift(b[..., cols, :], fwd_idx)
    sy = torch.matmul(row_oneh, bits_e)
    return torch.all(torch.remainder(torch.round(sy), 2.0) == 0, dim=-1).all(dim=-1)


# ----------------------------------------------------------------- rate matching


def rv_start(bg: int, rv: int, n_cb: int, z: int) -> int:
    """§5.4.2.1 Table 5.4.2.1-2: k0 for RV 0..3."""
    if bg == 1:
        num = {0: 0, 1: 17, 2: 33, 3: 56}[rv]
        return (num * n_cb // (66 * z)) * z
    num = {0: 0, 1: 13, 2: 25, 3: 43}[rv]
    return (num * n_cb // (50 * z)) * z


@lru_cache(maxsize=256)
def _rv_k0_virtual(bg: int, z: int, n_filler: int, k: int) -> np.ndarray:
    """Per-RV circular-buffer start in VIRTUAL (filler-removed) coordinates:
    k0 minus the fillers below it (a k0 inside the filler block maps to the
    first position after it)."""
    code_n = (66 if bg == 1 else 50) * z
    f_start = k - n_filler - 2 * z
    out = []
    for rv in range(4):
        k0 = rv_start(bg, rv, code_n, z)
        out.append(k0 - min(max(k0 - f_start, 0), n_filler))
    return np.asarray(out, np.int32)


def rate_match(codeword: torch.Tensor, bg: int, z: int, e_bits: int, rv: int,
               n_filler: int, k: int, qm: int) -> torch.Tensor:
    """Full codeword [..., n_full] -> transmitted bits [..., E]: puncture the
    first 2Z bits, drop fillers, circular selection from the RV start with
    repetition, then the §5.4.2.2 [Qm, E/Qm] interleaver transpose."""
    lead = codeword.shape[:-1]
    buf = codeword[..., 2 * z:]
    f_start, f_end = k - n_filler - 2 * z, k - 2 * z
    vbuf = torch.cat([buf[..., :f_start], buf[..., f_end:]], dim=-1) if n_filler else buf
    n_v = vbuf.shape[-1]
    r = torch.roll(vbuf, -int(_rv_k0_virtual(bg, z, n_filler, k)[int(rv)]), dims=-1)
    reps = -(-e_bits // n_v)
    e = torch.cat([r] * reps, dim=-1)[..., :e_bits] if reps > 1 else r[..., :e_bits]
    return e.reshape(*lead, qm, e_bits // qm).transpose(-1, -2).reshape(*lead, e_bits)


def rate_recover(
    llr_e: torch.Tensor, bg: int, z: int, rv: int, n_filler: int, k: int, qm: int,
    soft_buffer: torch.Tensor | None = None, filler_llr: float = 1e4,
):
    """Received LLRs [..., E] -> (full-codeword LLRs [..., n_full], circular
    buffer [..., Ncb]), combining into soft_buffer (HARQ) when given.
    Punctured bits get LLR 0, fillers a large bit-0 LLR.

    The circular scatter-add is a fold-sum over n_v-long chunks. It is summed
    explicitly left to right — the order of the reference's reduce — so
    repeated bits combine to the same float32 bits."""
    e_bits = llr_e.shape[-1]
    lead = llr_e.shape[:-1]
    deint = (llr_e.reshape(*lead, e_bits // qm, qm)
             .transpose(-1, -2).reshape(*lead, e_bits))
    code_n = (66 if bg == 1 else 50) * z
    n_v = code_n - n_filler
    pad = (-e_bits) % n_v
    if pad:
        deint = torch.cat([deint, deint.new_zeros((*lead, pad))], dim=-1)
    chunks = deint.reshape(*lead, -1, n_v)
    folded = chunks[..., 0, :]
    for j in range(1, chunks.shape[-2]):
        folded = folded + chunks[..., j, :]
    vbuf = torch.roll(folded, int(_rv_k0_virtual(bg, z, n_filler, k)[int(rv)]), dims=-1)
    f_start, f_end = k - n_filler - 2 * z, k - 2 * z
    if n_filler > 0:
        buf = torch.cat(
            [vbuf[..., :f_start], vbuf.new_zeros((*lead, n_filler)), vbuf[..., f_start:]],
            dim=-1,
        )
    else:
        buf = vbuf
    if soft_buffer is not None:
        buf = buf + soft_buffer
    if n_filler > 0:
        mask = torch.zeros(code_n, dtype=buf.dtype, device=buf.device)
        mask[f_start:f_end] = 1.0
        buf = buf * (1.0 - mask) + mask * filler_llr
    punct = llr_e.new_zeros((*lead, 2 * z))
    return torch.cat([punct, buf], dim=-1), buf
