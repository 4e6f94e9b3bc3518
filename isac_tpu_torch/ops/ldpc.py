"""QC-LDPC per TS 38.212 §5.3.2: lifted codes, encoding, parity check and
rate matching (counterpart of isac_tpu/ops/ldpc.py).

This is the reference's CPU formulation: the cyclic Z-shifts are precomputed
gathers and every per-row XOR sum is a one-hot [rows, edges] float32 product
taken mod 2 (exact: the sums are small integers). The reference's TPU-only
static-roll branch (``_use_static_rolls``) gives the same bits and is not
ported. Layered decoding lives in ldpc_layered.py; the flooding decoder is
``decode`` below.
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


def _shift_idx(shifts: np.ndarray, z: int, inverse: bool = False) -> np.ndarray:
    """[E, Z] gather index (i + s) % z: (P^s v)[i] = v[(i+s) mod Z]; inverse
    gives (i - s) % z."""
    i = np.arange(z)[None, :]
    s = shifts[:, None]
    return ((i - s) % z if inverse else (i + s) % z).astype(np.int64)


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


# --------------------------------------------------------------- flooding decoder


@lru_cache(maxsize=32)
def _decode_plan(bg: int, z: int):
    """Precomputed gathers for the flooding min-sum decoder."""
    code = lifted_code(bg, z)
    e_count = code.rows.shape[0]
    # group edges by row, padded to max degree
    dmax = int(np.max(np.bincount(code.rows)))
    row_edges = np.full((code.n_rows, dmax), -1, np.int64)
    fill = np.zeros(code.n_rows, np.int64)
    for e in range(e_count):
        r = code.rows[e]
        row_edges[r, fill[r]] = e
        fill[r] += 1
    row_pad = row_edges < 0
    row_edges = np.maximum(row_edges, 0)
    # position of edge within its row group (for scatter-back)
    edge_slot = np.zeros(e_count, np.int64)
    for r in range(code.n_rows):
        for d in range(dmax):
            if not row_pad[r, d]:
                edge_slot[row_edges[r, d]] = d
    # one-hot col aggregation matrix [n_cols, E]
    col_onehot = np.zeros((code.n_cols, e_count), np.float32)
    col_onehot[code.cols, np.arange(e_count)] = 1.0
    fwd_idx = _shift_idx(code.shifts, z, inverse=False)
    inv_idx = _shift_idx(code.shifts, z, inverse=True)
    return code, row_edges, row_pad, edge_slot, col_onehot, fwd_idx, inv_idx, dmax


@lru_cache(maxsize=64)
def _decode_tensors(bg: int, z: int, device: torch.device) -> dict:
    code, row_edges, row_pad, edge_slot, col_onehot, fwd_idx, inv_idx, _ = _decode_plan(bg, z)
    arrays = {
        "cols": code.cols.astype(np.int64),
        "rows": code.rows.astype(np.int64),
        "row_edges": row_edges,
        "real": (~row_pad)[..., None],  # [R, D, 1] True where a real edge
        "slot": edge_slot,
        "col_oneh": col_onehot,
        "fwd_idx": fwd_idx,
        "inv_idx": inv_idx,
    }
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def _decode_flooding(llr: torch.Tensor, bg: int, z: int, n_iter: int, norm: float,
                     early_exit: bool, exit_dims: int | None = None):
    """The flooding decoder with its iteration counts. Returns (hard [..., K]
    int8, parity_ok [...] bool, iterations run, one per stop group).

    exit_dims: how many trailing batch axes share ONE early-exit decision
    (None: all of them, i.e. one decision for the call, as the reference's
    while_loop over the call's batch). Leading axes beyond that are stop
    groups of their own: a finished group's messages and totals are frozen
    while the others run — what the reference's vmap over grants gives.
    The all-groups-done test is one device-to-host read per iteration."""
    code = lifted_code(bg, z)
    t = _decode_tensors(bg, z, llr.device)
    batch = llr.shape[:-1]
    nb = len(batch)
    ed = nb if exit_dims is None else exit_dims
    group_shape = batch[: nb - ed]
    lv = llr.reshape(*batch, code.n_cols, z).to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=llr.device)
    d_iota = torch.arange(t["row_edges"].shape[1], device=llr.device)[:, None]  # [D, 1]

    def body(c2v, total):
        # variable -> check (in the shifted/check domain)
        v2c = _gather_shift(total[..., t["cols"], :], t["fwd_idx"]) - c2v
        # check node: min-sum with self-exclusion via min1/min2
        grp = v2c[..., t["row_edges"], :]  # [..., R, D, Z]
        real = t["real"]
        mag = torch.where(real, torch.abs(grp), inf)
        # sign(0) must be +1 (punctured zero-LLRs would zero the products)
        sgn = torch.where(real & (grp < 0), -1.0, 1.0)
        m1, arg = torch.min(mag, dim=-2, keepdim=True)
        own = d_iota == arg
        m2 = torch.amin(torch.where(own, inf, mag), dim=-2, keepdim=True)
        sprod = torch.prod(sgn, dim=-2, keepdim=True)
        out = norm * sprod * sgn * torch.where(own, m2, m1)  # exclude own sign/mag
        out = torch.where(real, out, torch.zeros_like(out))
        # scatter back per edge: edge e lives at (row[e], slot[e])
        new_c2v = out[..., t["rows"], t["slot"], :]
        # check -> variable (unshift) and aggregate per column
        agg = torch.matmul(t["col_oneh"], _gather_shift(new_c2v, t["inv_idx"]))
        return new_c2v, lv + agg

    def group_ok(total):
        ok = parity_check((total < 0).reshape(*batch, code.n_cols * z), bg, z)
        return ok.reshape(*group_shape, -1).all(dim=-1)

    c2v = lv.new_zeros((*batch, code.rows.shape[0], z))
    total = lv
    iters = torch.zeros(group_shape, dtype=torch.int32, device=llr.device)
    if early_exit:
        done = torch.zeros(group_shape, dtype=torch.bool, device=llr.device)
        for it in range(n_iter):
            if it and bool(done.all()):
                break
            new_c2v, new_total = body(c2v, total)
            if group_shape:
                act = (~done).reshape(*group_shape, *([1] * (ed + 2)))
                c2v = torch.where(act, new_c2v, c2v)
                total = torch.where(act, new_total, total)
            else:
                c2v, total = new_c2v, new_total
            iters = iters + (~done).to(torch.int32)
            done = done | group_ok(total)
    else:
        for _ in range(n_iter):
            c2v, total = body(c2v, total)
        iters = iters + n_iter
    hard_full = (total < 0).to(torch.int8).reshape(*batch, code.n_cols * z)
    return hard_full[..., : code.k], parity_check(hard_full, bg, z), iters


def decode(llr: torch.Tensor, bg: int, z: int, n_iter: int = 6, norm: float = 0.75,
           early_exit: bool = False):
    """Flooding normalized min-sum. llr [..., n_full] (positive = bit 0)
    -> (hard bits [..., K] int8, parity_ok [...] bool).

    early_exit (opt-in; the default keeps a codeword's iteration count and
    posterior independent of its batch-mates): stop as soon as EVERY codeword
    of the call's batch satisfies all parity checks, at most n_iter
    iterations. A failing codeword keeps every codeword of the call running
    with it."""
    hard, ok, _ = _decode_flooding(llr, bg, z, n_iter, norm, early_exit)
    return hard, ok


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


def rate_match_indices(
    bg: int, z: int, e_bits: int, rv: int, n_filler: int, k: int, n_cb: int | None = None
) -> np.ndarray:
    """Circular-buffer bit-selection indices (§5.4.2.1), skipping filler bits.

    Returns positions into the PUNCTURED codeword (length 66Z/50Z, i.e. the
    full codeword minus its first 2Z bits)."""
    code_n = (66 if bg == 1 else 50) * z
    if n_cb is None:
        n_cb = code_n
    k0 = rv_start(bg, rv, n_cb, z)
    f_start, f_end = k - n_filler - 2 * z, k - 2 * z
    circ = (k0 + np.arange(n_cb)) % n_cb
    sel = circ[~((circ >= f_start) & (circ < f_end))]
    reps = int(np.ceil(e_bits / sel.shape[0]))
    return np.tile(sel, reps)[:e_bits]


def interleave_indices(e_bits: int, qm: int) -> np.ndarray:
    """§5.4.2.2 bit interleaver: f = e.reshape(Qm, E/Qm).T.ravel(). Returns perm
    such that f = e[perm]."""
    return np.arange(e_bits).reshape(qm, e_bits // qm).T.ravel()


@lru_cache(maxsize=512)
def rate_match_indices_all_rv(bg: int, z: int, e_bits: int, n_filler: int, k: int):
    """[4, E] bit-selection indices for every RV."""
    return np.stack(
        [rate_match_indices(bg, z, e_bits, rv, n_filler, k) for rv in range(4)]
    )


@lru_cache(maxsize=256)
def _rv_k0_dev(bg: int, z: int, n_filler: int, k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_rv_k0_virtual(bg, z, n_filler, k).astype(np.int64), device=device)


def _roll_per_item(x: torch.Tensor, shift) -> torch.Tensor:
    """torch.roll(x, shift, -1) with an int shift, or with a per-item integer
    tensor `shift` broadcastable to x.shape[:-1] (one gather; the same
    elements land in the same places, so bits and floats are unchanged)."""
    if not torch.is_tensor(shift):
        return torch.roll(x, int(shift), dims=-1)
    n = x.shape[-1]
    idx = torch.remainder(torch.arange(n, device=x.device) - shift[..., None], n)
    return torch.gather(x, -1, idx.expand(x.shape))


def _rv_shift(rv, bg: int, z: int, n_filler: int, k: int, like: torch.Tensor):
    """Virtual circular-buffer start for rv: a Python int for an int rv, else
    a tensor gathered from the four starts (rv: integer tensor, one entry per
    leading index of `like`, given with a trailing 1 for the code-block axis)."""
    if torch.is_tensor(rv):
        return _rv_k0_dev(bg, z, n_filler, k, like.device)[rv.to(torch.int64)]
    return int(_rv_k0_virtual(bg, z, n_filler, k)[int(rv)])


def rate_match(codeword: torch.Tensor, bg: int, z: int, e_bits: int, rv,
               n_filler: int, k: int, qm: int) -> torch.Tensor:
    """Full codeword [..., n_full] -> transmitted bits [..., E]: puncture the
    first 2Z bits, drop fillers, circular selection from the RV start with
    repetition, then the §5.4.2.2 [Qm, E/Qm] interleaver transpose.

    rv: a Python int for the whole batch, or an integer tensor broadcastable
    to codeword.shape[:-1] (a batch that mixes new and repeated transmissions)."""
    lead = codeword.shape[:-1]
    buf = codeword[..., 2 * z:]
    f_start, f_end = k - n_filler - 2 * z, k - 2 * z
    vbuf = torch.cat([buf[..., :f_start], buf[..., f_end:]], dim=-1) if n_filler else buf
    n_v = vbuf.shape[-1]
    r = _roll_per_item(vbuf, -_rv_shift(rv, bg, z, n_filler, k, vbuf))
    reps = -(-e_bits // n_v)
    e = torch.cat([r] * reps, dim=-1)[..., :e_bits] if reps > 1 else r[..., :e_bits]
    return e.reshape(*lead, qm, e_bits // qm).transpose(-1, -2).reshape(*lead, e_bits)


def rate_recover(
    llr_e: torch.Tensor, bg: int, z: int, rv, n_filler: int, k: int, qm: int,
    soft_buffer: torch.Tensor | None = None, filler_llr: float = 1e4,
):
    """Received LLRs [..., E] -> (full-codeword LLRs [..., n_full], circular
    buffer [..., Ncb]), combining into soft_buffer (HARQ) when given.
    Punctured bits get LLR 0, fillers a large bit-0 LLR. rv as in rate_match.

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
    vbuf = _roll_per_item(folded, _rv_shift(rv, bg, z, n_filler, k, folded))
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
