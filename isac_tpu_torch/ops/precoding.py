"""Type-1 single-panel codebook (numpy; counterpart of the codebook part of
isac_tpu/ops/precoding.py). Host-side tables [n_codewords, n_ports, n_layers]
as in TS 38.214 T5.2.2.2.1-x (pmiType1SinglePanelCodebook.m).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def type1_codebook(n1: int, n2: int, rank: int, o1: int = 4,
                   o2: int | None = None) -> np.ndarray:
    """Type-1 single-panel codebook, codebookMode 1. Returns
    [n_cw, 2*N1*N2, rank].

    TS 38.214 T5.2.2.2.1-5..8: rank 1 is W = [v_lm ; phi_n v_lm]/sqrt(P);
    rank 2..4 pair orthogonal beams (i13 beam-offset construction) with
    +-phi co-phasing. Ranks > 2 use the orthogonal-beam generalization.
    (codebookMode 2 is not ported: the link step draws from mode 1.)
    """
    if o2 is None:
        o2 = 4 if n2 > 1 else 1
    p = 2 * n1 * n2

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


def csirs_panel_dims(n_ports: int) -> tuple:
    """(N1, N2) per TS 38.214 T5.2.2.2.1-2 (csirsPanelDimensions.m:1-20)."""
    table = {2: (1, 1), 4: (2, 1), 8: (2, 2), 12: (3, 2), 16: (4, 2), 24: (4, 3), 32: (4, 4)}
    if n_ports not in table:
        raise ValueError(f"unsupported CSI-RS port count {n_ports}")
    return table[n_ports]

