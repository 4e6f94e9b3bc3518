"""CSI measurement/selection: RI, PMI, CQI (DL via CSI-RS; UL via SRS/TPMI)
(counterpart of isac_tpu/ops/csi.py).

Equivalents of the reference's ported MathWorks helpers:
- riSelect.m:1-531 (rank by per-rank capacity)
- dlPMISelect.m:1-1887 (Type-1 codebook search maximizing SINR)
- cqiSelect.m:1-1244 (per-RE SINR -> subband/wideband CQI via BLER-0.1 table)
- pmiSelect.m:28-66 + precodedSINR.m + sinrPerSubband.m (UL TPMI from SRS)
- setupSINRtoCQIMappingTable.m:1-14 (the hard-coded SINR thresholds)
- subbandSize.m (TS 38.214 T5.2.1.4-2; the FIRST valid size, not the
  reference's random pick)

The codebook searches are batched einsums over [codeword, RE]. Every arg-max
takes the first maximum (torch.argmax's contract), so where a codebook holds
the same matrix under two indices the lower index wins, as with jnp.argmax.
Codebooks and subband-averaging matrices are uploaded once per (key, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.ops.channel_est import _small_hermitian_inverse
from isac_tpu_torch.ops.precoding import (
    pusch_codebook,
    type1_codebook,
    type1_multipanel_codebook,
)

# SINR (dB) thresholds for CQI 1..15 at BLER 0.1 (setupSINRtoCQIMappingTable.m:7-11)
SINR_TO_CQI_DL = np.array(
    [-3.46, 1.54, 6.54, 11.05, 13.54, 16.04, 17.54, 20.04, 22.04, 24.43,
     26.93, 27.43, 29.43, 32.43, 35.43]
)
SINR_TO_CQI_UL = SINR_TO_CQI_DL - 2.0

# TS 38.214 Table 5.2.2.1-2 (CQI table 1): (modulation, coderate*1024)
CQI_TABLE = [
    None,
    ("QPSK", 78), ("QPSK", 120), ("QPSK", 193), ("QPSK", 308), ("QPSK", 449),
    ("QPSK", 602), ("16QAM", 378), ("16QAM", 490), ("16QAM", 616), ("64QAM", 466),
    ("64QAM", 567), ("64QAM", 666), ("64QAM", 772), ("64QAM", 873), ("64QAM", 948),
]


def subband_size(n_prb: int) -> int:
    """TS 38.214 Table 5.2.1.4-2 — first valid value (deterministic)."""
    if n_prb < 24:
        return n_prb  # wideband only
    if n_prb <= 72:
        return 4
    if n_prb <= 144:
        return 8
    return 16


@lru_cache(maxsize=8)
def _cqi_thresholds(table_key: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(table_key, np.float64).astype(np.float32),
                           device=device)


def sinr_to_cqi(sinr_db: torch.Tensor, table: np.ndarray = SINR_TO_CQI_DL) -> torch.Tensor:
    """Highest CQI whose threshold <= SINR (0 = out of range)."""
    t = _cqi_thresholds(np.asarray(table, np.float64).tobytes(), sinr_db.device)
    return torch.sum(sinr_db[..., None] >= t, dim=-1).to(torch.int32)


def precoded_sinr(h: torch.Tensor, w: torch.Tensor, nvar) -> torch.Tensor:
    """Post-MMSE SINR per layer for a precoded channel.

    h [..., n_rx, n_ports], w [n_cw, n_ports, n_layers] ->
    sinr [n_cw, ..., n_layers] (linear). LMMSE formulation of precodedSINR.m,
    in the numerically stable form SINR_l = 1/[(I + H_eff^H H_eff / nvar)^-1]_ll - 1
    (the textbook mu/(1-mu) form cancels in float32 above ~60 dB SNR)."""
    heff = torch.einsum("...rp,cpl->c...rl", h, w)
    hh = torch.conj(heff.transpose(-1, -2))
    a = torch.matmul(hh, heff) / nvar
    n_layers = w.shape[-1]
    b = a + torch.eye(n_layers, dtype=a.dtype, device=a.device)
    binv = _small_hermitian_inverse(b)
    d = torch.clamp(torch.real(torch.diagonal(binv, dim1=-2, dim2=-1)), 1e-12, 1.0)
    sinr = 1.0 / d - 1.0
    return torch.where(torch.isfinite(sinr), torch.clamp_min(sinr, 0.0),
                       torch.zeros_like(sinr))


def ri_select(h: torch.Tensor, nvar, max_rank: int = 4) -> torch.Tensor:
    """Rank by per-rank Shannon capacity on the channel singular values
    (riSelect.m approach). h [n_re, n_rx, n_tx] -> rank (0-d tensor, 1-based).

    Singular values come from the Gram matrix of the smaller side: analytic
    eigenvalues when n_rx or n_tx is at most 2 (H H^H and H^H H share their
    non-zero eigenvalues, and only min(n_rx, n_tx) of them are used), so the
    card never waits for the host; eigvalsh of H H^H above, whose error check
    synchronises the card with the host. The reference takes eigvalsh of
    H H^H whenever n_rx > 2, so for the uplink's 16 receive antennas the
    singular values agree with it to float32 rounding, not bit for bit."""
    n_rx, n_tx = h.shape[-2], h.shape[-1]
    if min(n_rx, n_tx) <= 2:
        hc = torch.conj(h.transpose(-1, -2))
        g = torch.matmul(h, hc) if n_rx <= n_tx else torch.matmul(hc, h)  # [.., m, m]
        if g.shape[-1] == 1:
            s = torch.sqrt(torch.clamp_min(torch.real(g[..., 0, 0]), 0.0))[..., None]
        else:
            tr = torch.real(g[..., 0, 0] + g[..., 1, 1])
            det = torch.real(g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] * g[..., 1, 0])
            disc = torch.sqrt(torch.clamp_min(tr * tr / 4.0 - det, 0.0))
            e1 = torch.clamp_min(tr / 2.0 + disc, 0.0)
            e2 = torch.clamp_min(tr / 2.0 - disc, 0.0)
            s = torch.sqrt(torch.stack([e1, e2], dim=-1))  # descending
    else:
        g = torch.matmul(h, torch.conj(h.transpose(-1, -2)))  # H H^H [.., rx, rx]
        ev = torch.linalg.eigvalsh(g)  # ascending, real
        s = torch.sqrt(torch.clamp_min(torch.flip(ev, dims=(-1,)), 0.0))  # descending
    max_rank = min(max_rank, h.shape[-1], h.shape[-2])
    caps = []
    for r in range(1, max_rank + 1):
        # equal power split across r layers
        cap = torch.sum(torch.log2(1.0 + (s[..., :r] ** 2) / (r * nvar)), dim=-1)
        caps.append(torch.mean(cap))
    return torch.argmax(torch.stack(caps)) + 1


@lru_cache(maxsize=64)
def _codebook_dev(kind: str, args: tuple, device: torch.device) -> torch.Tensor:
    if kind == "mp":
        ng, n1, n2, rank, mode = args
        cb = type1_multipanel_codebook(ng, n1, n2, rank, codebook_mode=mode)
    elif kind == "sp":
        n1, n2, rank, mode = args
        cb = type1_codebook(n1, n2, rank, codebook_mode=mode)
    else:
        cb = pusch_codebook(*args)
    return torch.as_tensor(cb.astype(np.complex64), device=device)


def _subband_mean_matrix(subband_of_re, device: torch.device) -> torch.Tensor:
    """[n_sb, n_re] averaging matrix (1/count on each RE of the subband), on
    the device once per (subband map, device)."""
    sb = np.asarray(subband_of_re, np.int64)
    return _subband_mean_matrix_dev(sb.tobytes(), device)


@lru_cache(maxsize=64)
def _subband_mean_matrix_dev(sb_bytes: bytes, device: torch.device) -> torch.Tensor:
    sb = np.frombuffer(sb_bytes, np.int64)
    n_sb = int(sb.max()) + 1
    oneh = np.zeros((n_sb, sb.shape[0]), np.float32)
    oneh[sb, np.arange(sb.shape[0])] = 1.0
    oneh = oneh / np.maximum(oneh.sum(axis=1, keepdims=True), 1.0)
    return torch.as_tensor(oneh, device=device)


def dl_pmi_select(
    h: torch.Tensor,  # [n_re, n_rx, n_ports] channel estimates at CSI-RS REs
    nvar,
    rank: int,
    n1: int,
    n2: int,
    subband_of_re: np.ndarray | None = None,  # [n_re] subband id (None = wideband)
    ng: int = 1,
    codebook_mode: int = 1,
):
    """Type-1 codebook search maximizing sum capacity (dlPMISelect.m analogue).

    ng > 1 searches the multi-panel codebook (TS 38.214 section 5.2.2.2.2);
    codebook_mode selects codebookMode 1 or 2 for either family.

    Returns (pmi_wideband, pmi_per_subband [n_sb], sinr_per_subband [n_sb, rank]).
    """
    if ng > 1:
        cb = _codebook_dev("mp", (ng, n1, n2, rank, codebook_mode), h.device)
    else:
        cb = _codebook_dev("sp", (n1, n2, rank, codebook_mode), h.device)
    sinr = precoded_sinr(h, cb, nvar)  # [n_cw, n_re, rank]
    cap = torch.sum(torch.log2(1.0 + sinr), dim=-1)  # [n_cw, n_re]
    if subband_of_re is None:
        best = torch.argmax(torch.mean(cap, dim=-1))
        return best, best[None], torch.mean(sinr[best], dim=0, keepdim=True)
    oneh = _subband_mean_matrix(subband_of_re, h.device)
    sb_cap = torch.matmul(cap, oneh.T)  # [n_cw, n_sb]
    pmi_sb = torch.argmax(sb_cap, dim=0)  # [n_sb]
    pmi_wb = torch.argmax(torch.mean(sb_cap, dim=-1))
    sb_sinr = torch.einsum("se,cel->csl", oneh, sinr)
    sinr_sel = torch.take_along_dim(sb_sinr, pmi_sb[None, :, None], dim=0)[0]
    return pmi_wb, pmi_sb, sinr_sel


def cqi_select(
    h: torch.Tensor,  # [n_re, n_rx, n_ports]
    nvar,
    rank: int,
    n1: int,
    n2: int,
    subband_of_re: np.ndarray | None = None,
    ng: int = 1,
):
    """CQI from post-precoding SINR (cqiSelect.m analogue).

    Returns dict: rank, pmi_wb, pmi_sb, cqi_wb, cqi_sb [n_sb], sinr_db_sb.
    """
    pmi_wb, pmi_sb, sinr_sb = dl_pmi_select(h, nvar, rank, n1, n2, subband_of_re, ng=ng)
    # layer-average effective SINR per subband (arithmetic in the dB domain)
    layer_mean = torch.mean(sinr_sb, dim=-1)
    sinr_db = 10.0 * torch.log10(torch.clamp_min(layer_mean, 1e-9))
    cqi_sb = sinr_to_cqi(sinr_db, SINR_TO_CQI_DL)
    cqi_wb = sinr_to_cqi(10.0 * torch.log10(torch.clamp_min(torch.mean(layer_mean), 1e-9)))
    return {
        "rank": rank,
        "pmi_wb": pmi_wb,
        "pmi_sb": pmi_sb,
        "cqi_wb": cqi_wb,
        "cqi_sb": cqi_sb,
        "sinr_db_sb": sinr_db,
    }


def ul_tpmi_select(
    h: torch.Tensor,  # [n_re, n_rx, n_ue_ports] channel from SRS
    nvar,
    rank: int,
    subband_of_re: np.ndarray | None = None,
):
    """UL TPMI via PUSCH codebook (pmiSelect.m:28-66).

    Returns (tpmi, sinr_db_per_subband [n_sb])."""
    cb = _codebook_dev("pusch", (h.shape[-1], rank), h.device)
    sinr = precoded_sinr(h, cb, nvar)  # [n_cw, n_re, rank]
    cap = torch.sum(torch.log2(1.0 + sinr), dim=-1)
    tpmi = torch.argmax(torch.mean(cap, dim=-1))
    sel = torch.index_select(sinr, 0, tpmi[None])[0]  # [n_re, rank], no host read of tpmi
    if subband_of_re is None:
        return tpmi, 10.0 * torch.log10(torch.clamp_min(torch.mean(sel), 1e-9))[None]
    oneh = _subband_mean_matrix(subband_of_re, h.device)
    sb_sinr = torch.matmul(oneh, sel)
    return tpmi, 10.0 * torch.log10(torch.clamp_min(torch.mean(sb_sinr, dim=-1), 1e-9))
