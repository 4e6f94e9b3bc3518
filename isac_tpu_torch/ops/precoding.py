"""Precoding: Type-1 single- and multi-panel codebooks, PRG-bundled precoding,
PUSCH codebook (counterpart of isac_tpu/ops/precoding.py).

Equivalents of pmiType1SinglePanelCodebook.m (TS 38.214 T5.2.2.2.1-x: DFT
beams x co-phasing), the multi-panel tables of dlPMISelect.m:1351-1773
(TS 38.214 section 5.2.2.2.2, ranks 1-4; codebookMode 1 for Ng in {2,4},
codebookMode 2 for Ng=2), prgPrecode.m:53-144 and MATLAB nrPUSCHCodebook
(TS 38.211 T6.3.1.5-x).

Codebooks are host numpy tables [n_codewords, n_ports, n_layers], element for
element the reference's; the searches that use them are batched einsums
(ops/csi.py). prg_precode works on tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def type1_codebook(
    n1: int, n2: int, rank: int, o1: int = 4, o2: int | None = None,
    codebook_mode: int = 1,
) -> np.ndarray:
    """Type-1 single-panel codebook. Returns [n_cw, 2*N1*N2, rank].

    codebookMode 1 (TS 38.214 T5.2.2.2.1-5..8): rank 1 is
    W = [v_lm ; phi_n v_lm]/sqrt(P); rank 2..4 pair orthogonal beams
    (i13 beam-offset construction) with +-phi co-phasing. Ranks > 2 use the
    orthogonal-beam generalization.

    codebookMode 2 (dlPMISelect.m:912-945 / :1039-1082): i11/i12 step the
    beam grid by 2 and i2 jointly encodes a beam sub-offset within the
    oversampling cell plus the co-phase (16 i2 values at rank 1, 8 at
    rank 2). Defined for ranks 1-2 with more than 2 ports; ranks 3+ and
    2-port configs are mode-independent per the spec, so they fall through
    to the mode-1 table.
    """
    if o2 is None:
        o2 = 4 if n2 > 1 else 1
    p = 2 * n1 * n2
    if codebook_mode not in (1, 2):
        raise ValueError(f"codebook_mode must be 1 or 2, got {codebook_mode}")
    if codebook_mode == 2 and rank <= 2 and p > 2:
        return _type1_mode2_codebook(n1, n2, rank, o1, o2)

    def beam(l, m):
        v1 = np.exp(2j * np.pi * np.arange(n1) * l / (o1 * n1))
        v2 = np.exp(2j * np.pi * np.arange(n2) * m / (o2 * n2))
        return np.kron(v1, v2)  # [N1*N2]

    cws = []
    if rank == 1:
        for l in range(o1 * n1):
            for m in range(o2 * n2):
                v = beam(l, m)
                for n in range(4):
                    phi = np.exp(1j * np.pi * n / 2)
                    w = np.concatenate([v, phi * v]) / np.sqrt(p)
                    cws.append(w[:, None])
    else:
        # beam offset k1 for orthogonal second beam (i13 mechanism)
        offsets = [(0, 0)] if rank > 2 else [(0, 0), (o1, 0), (0, o2) if n2 > 1 else (2 * o1, 0)]
        offsets = [(o1 * (r % n1 if n1 > 1 else 0), 0) for r in range(1, rank)] if rank > 2 else offsets
        for l in range(o1 * n1):
            for m in range(o2 * n2):
                if rank == 2:
                    for k1, k2 in [(0, 0), (o1 if n1 > 1 else 0, 0 if n1 > 1 else o2)]:
                        v0 = beam(l, m)
                        v1 = beam(l + k1, m + k2)
                        for n in range(2):
                            phi = np.exp(1j * np.pi * n / 2)
                            w = np.stack(
                                [
                                    np.concatenate([v0, phi * v0]),
                                    np.concatenate([v1, -phi * v1]),
                                ],
                                axis=-1,
                            ) / np.sqrt(2 * p)
                            cws.append(w)
                else:
                    # ranks 3/4: `rank` orthogonal beams, alternating co-phase
                    cols = []
                    for r in range(rank):
                        lr = l + (r % max(n1, 1)) * o1
                        vr = beam(lr, m)
                        sgn = 1.0 if r % 2 == 0 else -1.0
                        cols.append(np.concatenate([vr, sgn * vr]))
                    w = np.stack(cols, axis=-1) / np.sqrt(rank * p)
                    cws.append(w)
    return np.asarray(cws, np.complex64)


def _type1_mode2_codebook(n1: int, n2: int, rank: int, o1: int, o2: int) -> np.ndarray:
    """Single-panel codebookMode-2 table, ranks 1-2 (TS 38.214
    T5.2.2.2.1-5/-6; dlPMISelect.m:912-945, :1039-1082).

    i11 steps the first beam axis by 2 (range N1*O1/2); i12 likewise when
    N2 > 1; i2 packs (beam sub-offset within the 2x2 oversampling cell,
    co-phase n). Beam indices are periodic in Oi*Ni, so sub-offsets past the
    grid edge wrap naturally through the DFT exponential."""
    p = 2 * n1 * n2

    def beam(l, m):
        v1 = np.exp(2j * np.pi * np.arange(n1) * l / (o1 * n1))
        v2 = np.exp(2j * np.pi * np.arange(n2) * m / (o2 * n2))
        return np.kron(v1, v2)

    lm_add = [(0, 0), (1, 0), (0, 1), (1, 1)]
    i11s = range(n1 * o1 // 2)
    i12s = range(n2 * o2 // 2) if n2 > 1 else (0,)
    cws = []
    if rank == 1:
        for i11 in i11s:
            for i12 in i12s:
                for i2 in range(16):
                    if n2 == 1:
                        l, m = 2 * i11 + i2 // 4, 0
                    else:
                        al, am = lm_add[i2 // 4]
                        l, m = 2 * i11 + al, 2 * i12 + am
                    v = beam(l, m)
                    phi = np.exp(1j * np.pi * (i2 % 4) / 2)
                    cws.append(np.concatenate([v, phi * v])[:, None] / np.sqrt(p))
    else:
        if n1 > n2 and n2 > 1:
            offs = [(0, 0), (o1, 0), (0, o2), (2 * o1, 0)]
        elif n1 == n2:
            offs = [(0, 0), (o1, 0), (0, o2), (o1, o2)]
        elif (n1, n2) == (2, 1):
            offs = [(0, 0), (o1, 0)]
        else:
            offs = [(0, 0), (o1, 0), (2 * o1, 0), (3 * o1, 0)]
        for i11 in i11s:
            for i12 in i12s:
                for k1, k2 in offs:
                    for i2 in range(8):
                        if n2 == 1:
                            l, m = 2 * i11 + i2 // 2, 0
                        else:
                            al, am = lm_add[i2 // 2]
                            l, m = 2 * i11 + al, 2 * i12 + am
                        v0 = beam(l, m)
                        v1 = beam(l + k1, m + k2)
                        phi = np.exp(1j * np.pi * (i2 % 2) / 2)
                        w = np.stack(
                            [np.concatenate([v0, phi * v0]),
                             np.concatenate([v1, -phi * v1])], axis=-1,
                        ) / np.sqrt(2 * p)
                        cws.append(w)
    return np.asarray(cws, np.complex64)


# TS 38.214 Table 5.2.2.2.2-1: supported multi-panel (Ng, N1, N2) configs.
MULTI_PANEL_CONFIGS = frozenset(
    [(2, 2, 1), (2, 4, 1), (4, 2, 1), (2, 2, 2), (2, 8, 1), (4, 4, 1), (2, 4, 2), (4, 2, 2)]
)


def _mp_beam_offsets(n1: int, n2: int, o1: int, o2: int, rank: int) -> list:
    """(k1, k2) second-beam offsets per i13, TS 38.214 Table 5.2.2.2.2-2."""
    if rank == 2:
        if n1 > n2 and n2 > 1:
            return [(0, 0), (o1, 0), (0, o2), (2 * o1, 0)]
        if n1 == n2:
            return [(0, 0), (o1, 0), (0, o2), (o1, o2)]
        if (n1, n2) == (2, 1):
            return [(0, 0), (o1, 0)]
        return [(0, 0), (o1, 0), (2 * o1, 0), (3 * o1, 0)]
    table = {
        (2, 1): [(o1, 0)],
        (4, 1): [(o1, 0), (2 * o1, 0), (3 * o1, 0)],
        (8, 1): [(o1, 0), (2 * o1, 0), (3 * o1, 0), (4 * o1, 0)],
        (2, 2): [(o1, 0), (0, o2), (o1, o2)],
        (4, 2): [(o1, 0), (0, o2), (o1, o2), (2 * o1, 0)],
    }
    return table[(n1, n2)]


@lru_cache(maxsize=32)
def type1_multipanel_codebook(
    ng: int, n1: int, n2: int, rank: int, o1: int = 4, o2: int | None = None,
    codebook_mode: int = 1,
) -> np.ndarray:
    """Type-1 multi-panel codebook (TS 38.214 §5.2.2.2.2, Tables 5.2.2.2.2-3..6).

    Returns [n_cw, 2*Ng*N1*N2, rank] complex64. Port ordering is panel-major
    with polarization within panel (port = (2g + pol)*N1*N2 + element) — the
    same block stacking the reference materializes
    (dlPMISelect.m:1455-1459: [v; phi_n v; phi_p v; phi_n phi_p v]).

    Construction (vectorized, no index loop nest): every codeword column is
        c_g(combo) * phi_n(combo)^pol * sign(col)^pol * v_beam(col)
    over a broadcast grid of (beam l,m) x (i13 beam pair) x (phase combo),
    where c_g are the per-panel co-phases (phi_p / a*b factors), phi_n the
    polarization co-phase, and sign/beam the per-column rank pattern
    ([+],[+,-],[+,+,-],[+,+,-,-] over beams [0],[0,1],[0,1,0],[0,1,0,1]).

    codebookMode 1 covers Ng in {2, 4}; codebookMode 2 (independent per-pol
    panel-2 phases a(p)b(n), dlPMISelect.m:1489-1496) covers Ng = 2 only,
    per TS 38.214. Memory note: the largest table, (4,2,2) rank 4, is
    ~25 MB host-side; tables are lru-cached per config.
    """
    if o2 is None:
        o2 = 4 if n2 > 1 else 1
    if (ng, n1, n2) not in MULTI_PANEL_CONFIGS:
        raise ValueError(
            f"(Ng,N1,N2)=({ng},{n1},{n2}) is not a TS 38.214 T5.2.2.2.2-1 config"
        )
    if codebook_mode not in (1, 2):
        raise ValueError(f"codebook_mode must be 1 or 2, got {codebook_mode}")
    if codebook_mode == 2 and ng != 2:
        raise ValueError("codebookMode 2 is defined for Ng=2 only (TS 38.214 §5.2.2.2.2)")
    if not 1 <= rank <= 4:
        raise ValueError(f"multi-panel codebook covers ranks 1-4, got {rank}")
    p_ports = 2 * ng * n1 * n2
    n_elem = n1 * n2

    def phi(x):
        return np.exp(1j * np.pi * np.asarray(x, np.float64) / 2)

    def a_fac(x):
        return np.exp(1j * np.pi / 4 + 1j * np.pi * np.asarray(x, np.float64) / 2)

    def b_fac(x):
        return np.exp(-1j * np.pi / 4 + 1j * np.pi * np.asarray(x, np.float64) / 2)

    ls = np.arange(o1 * n1)
    ms = np.arange(o2 * n2)

    def beam_grid(k1: int, k2: int) -> np.ndarray:
        """DFT beams v_{l+k1, m+k2} for the full (l, m) grid -> [L, M, N1*N2]."""
        v1 = np.exp(2j * np.pi * np.outer(ls + k1, np.arange(n1)) / (o1 * n1))
        v2 = np.exp(2j * np.pi * np.outer(ms + k2, np.arange(n2)) / (o2 * n2))
        return np.einsum("la,mb->lmab", v1, v2).reshape(len(ls), len(ms), n_elem)

    col_beam = {1: [0], 2: [0, 1], 3: [0, 1, 0], 4: [0, 1, 0, 1]}[rank]
    col_sign = {1: [1.0], 2: [1.0, -1.0], 3: [1.0, 1.0, -1.0], 4: [1.0, 1.0, -1.0, -1.0]}[rank]
    n_pol_vals = 4 if rank == 1 else 2

    # Block phase factors F[combo, panel, pol] (column sign applied later).
    if codebook_mode == 1:
        n_panel_idx = ng - 1  # independent phi_p per non-reference panel
        grids = np.meshgrid(
            np.arange(n_pol_vals), *([np.arange(4)] * n_panel_idx), indexing="ij"
        )
        flat = [g.reshape(-1) for g in grids]
        phi_n = phi(flat[0])  # [C]
        c_g = np.stack(
            [np.ones_like(phi_n)] + [phi(f) for f in flat[1:]], axis=1
        )  # [C, ng]
        f_blk = np.stack([c_g, c_g * phi_n[:, None]], axis=2)  # [C, ng, 2]
    else:
        # Mode 2, Ng=2: panel-2 pols get independent a(p)b(n) phases
        # (dlPMISelect.m:1489-1496 / :1582-1594).
        grids = np.meshgrid(
            np.arange(n_pol_vals),  # n0
            np.arange(2), np.arange(2),  # n1, n2
            np.arange(4), np.arange(4),  # p1, p2
            indexing="ij",
        )
        n0, n1i, n2i, p1, p2 = [g.reshape(-1) for g in grids]
        ones = np.ones(n0.shape[0], np.complex128)
        f_blk = np.stack(
            [
                np.stack([ones, phi(n0)], axis=1),  # panel 1: [1, phi_n0]
                np.stack([a_fac(p1) * b_fac(n1i), a_fac(p2) * b_fac(n2i)], axis=1),
            ],
            axis=1,
        )  # [C, 2, 2]

    offsets = [(0, 0)] if rank == 1 else _mp_beam_offsets(n1, n2, o1, o2, rank)
    sgn = np.stack([np.ones(rank), np.asarray(col_sign)], axis=0)  # [pol, col]
    chunks = []
    for k1, k2 in offsets:
        pair = np.stack([beam_grid(0, 0), beam_grid(k1, k2)], axis=2)  # [L,M,2,E]
        cols = pair[:, :, col_beam, :]  # [L, M, R, E]
        # [L, M, C, ng, pol, E, R]
        w = (
            f_blk[None, None, :, :, :, None, None]
            * sgn[None, None, None, None, :, None, :]
            * cols[:, :, None, None, None].transpose(0, 1, 2, 3, 4, 6, 5)
        )
        lm = len(ls) * len(ms)
        chunks.append(w.reshape(lm * f_blk.shape[0], p_ports, rank))
    cb = np.concatenate(chunks, axis=0) / np.sqrt(rank * p_ports)
    return np.ascontiguousarray(cb.astype(np.complex64))


def csirs_panel_dims(n_ports: int) -> tuple:
    """(N1, N2) per TS 38.214 T5.2.2.2.1-2 (csirsPanelDimensions.m:1-20)."""
    table = {2: (1, 1), 4: (2, 1), 8: (2, 2), 12: (3, 2), 16: (4, 2), 24: (4, 3), 32: (4, 4)}
    if n_ports not in table:
        raise ValueError(f"unsupported CSI-RS port count {n_ports}")
    return table[n_ports]


def panel_dims_for_antenna(antenna) -> tuple:
    """(N1, N2) matching the PHYSICAL array geometry so the Type-1 codebook's
    2*N1*N2 ports equal the element count (validated with a clear error at
    construction).

    Type-1 single-panel codebooks are dual-polarized by construction
    (TS 38.214 §5.2.2.2.1); single-pol arrays are rejected here."""
    pol = getattr(antenna, "polarizations", 1)
    if pol != 2:
        raise ValueError(
            "Type-1 codebook CSI requires a cross-polarized array "
            f"(polarizations=2); got polarizations={pol}. Use a 2-pol "
            "ULA/UPA or disable codebook CSI."
        )
    if hasattr(antenna, "n_h"):  # UPA
        n1, n2 = antenna.n_h * antenna.n_ph, antenna.n_v * antenna.n_pv
    else:  # ULA
        n1, n2 = antenna.n_v, 1
    if 2 * n1 * n2 != antenna.num_elements:
        raise ValueError(
            f"panel dims ({n1},{n2}) x 2 pol != {antenna.num_elements} elements"
        )
    return n1, n2


def panel_config_for_antenna(antenna) -> tuple:
    """(Ng, N1, N2) for codebook CSI, honouring physical panels.

    A UPA whose (n_pv * n_ph, n_h, n_v) matches a TS 38.214 T5.2.2.2.2-1
    multi-panel configuration reports against the multi-panel codebook
    (Ng > 1); anything else folds its panels into one logical panel and uses
    the single-panel family, matching :func:`panel_dims_for_antenna` (which
    remains the single-panel compatibility surface)."""
    if hasattr(antenna, "n_h"):
        ng = getattr(antenna, "n_pv", 1) * getattr(antenna, "n_ph", 1)
        if ng > 1 and (ng, antenna.n_h, antenna.n_v) in MULTI_PANEL_CONFIGS:
            if getattr(antenna, "polarizations", 1) != 2:
                raise ValueError("multi-panel Type-1 CSI requires a 2-pol UPA")
            return ng, antenna.n_h, antenna.n_v
    n1, n2 = panel_dims_for_antenna(antenna)
    return 1, n1, n2


@lru_cache(maxsize=16)
def pusch_codebook(n_ports: int, rank: int) -> np.ndarray:
    """PUSCH TPMI codebook (TS 38.211 Tables 6.3.1.5-1..7, fully-coherent set).

    Returns [n_tpmi, n_ports, rank].
    """
    if n_ports == 1:
        return np.ones((1, 1, 1), np.complex64)
    j = 1j
    if n_ports == 2 and rank == 1:
        ws = [[1, 0], [0, 1], [1, 1], [1, -1], [1, j], [1, -j]]
        return (np.asarray(ws, np.complex64) / np.sqrt(2))[:, :, None]
    if n_ports == 2 and rank == 2:
        ws = [
            np.eye(2) / np.sqrt(2),
            np.array([[1, 1], [1, -1]]) / 2.0,
            np.array([[1, 1], [j, -j]]) / 2.0,
        ]
        return np.asarray(ws, np.complex64)
    if n_ports == 4 and rank == 1:
        ws = []
        for k in range(4):  # antenna selection
            e = np.zeros(4)
            e[k] = 1
            ws.append(e / 1.0)
        for ph1 in (1, -1, j, -j):
            for ph2 in (1, -1, j, -j):
                ws.append(np.array([1, ph1, ph2, ph1 * ph2]) / 2.0)
        return np.asarray(ws, np.complex64)[:, :, None]
    if n_ports == 4 and rank == 2:
        ws = []
        for ph in (1, j):
            for a, b in [(1, 1), (1, -1)]:
                w = np.array([[1, 1], [a, -a], [ph, ph * b], [ph * a, -ph * a * b]]) / (2 * np.sqrt(2))
                ws.append(w)
        ws.append(np.array([[1, 0], [0, 1], [1, 0], [0, 1]]) / 2.0)
        ws.append(np.array([[1, 0], [0, 1], [-1, 0], [0, -1]]) / 2.0)
        return np.asarray(ws, np.complex64)
    if n_ports == 4 and rank in (3, 4):
        # identity-based + DFT-based subset
        ws = []
        eye = np.eye(4)[:, :rank]
        ws.append(eye / np.sqrt(rank))
        f = np.fft.fft(np.eye(4)) / 2.0
        ws.append(f[:, :rank] / np.sqrt(rank / 4 * 4))
        return np.asarray(ws, np.complex64)
    raise ValueError(f"unsupported PUSCH codebook: {n_ports} ports rank {rank}")


def max_pusch_tpmi(n_ports: int, rank: int) -> int:
    """Number of TPMIs (maxPUSCHPrecodingMatrixIndicator.m analogue)."""
    return pusch_codebook(n_ports, rank).shape[0]


def prg_indices(n_prb: int, prg_size: int = 2) -> np.ndarray:
    """PRB -> PRG id (prgPrecode.m getPRGSet:94-100). [n_prb]."""
    return (np.arange(n_prb) // prg_size).astype(np.int32)


def prg_precode(
    layer_grid: torch.Tensor,  # [n_layers, n_sym, n_sc]
    w_per_prg: torch.Tensor,  # [n_prg, n_ports, n_layers]
    prb_start: int = 0,
    prg_size: int = 2,
) -> torch.Tensor:
    """PRG-bundled precoding -> antenna-port grid [n_ports, n_sym, n_sc].

    Each subcarrier uses its PRG's precoder (prgPrecode.m:103-139).
    """
    n_layers, n_sym, n_sc = layer_grid.shape
    prb_of_sc = (np.arange(n_sc) // 12) + prb_start
    prg_of_sc = (prb_of_sc // prg_size).astype(np.int64)
    prg_of_sc = prg_of_sc - prg_of_sc.min()
    w_sc = w_per_prg[torch.as_tensor(prg_of_sc, device=w_per_prg.device)]
    return torch.einsum("kpl,lsk->psk", w_sc, layer_grid)
