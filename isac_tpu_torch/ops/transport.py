"""Transport channels: TBS determination, segmentation, DL-SCH chains
(counterpart of isac_tpu/ops/transport.py).

Chain per TS 38.212: TB CRC (24A, or 16 if A<=3824) -> base-graph select ->
segmentation + per-CB CRC24B + fillers -> LDPC encode -> rate match
(RV circular buffer + Qm interleaver) -> concatenate. Decode mirrors it with
per-CB soft-buffer HARQ combining and the layered (default) or flooding
min-sum decoder. Every function takes any number of leading batch axes (the
link axis of the batched link step, the grant axis of the per-grant chains);
rv is a Python int for the whole batch or an integer tensor with one entry
per leading index.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.ops import ldpc
from isac_tpu_torch.ops.crc import crc_attach, crc_check, crc_length
from isac_tpu_torch.ops.ldpc_layered import decode_layered

# TS 38.214 Table 5.1.3.2-1 (TBS for Ninfo <= 3824)
TBS_TABLE = np.array([
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
])


def nr_tbs(
    modulation: str,
    n_layers: int,
    n_prb: int,
    nre_per_prb: int,
    target_code_rate: float,
    tb_scaling: float = 1.0,
    xoh: int = 0,
) -> int:
    """TS 38.214 §5.1.3.2 transport block size (nre_per_prb capped at 156)."""
    from isac_tpu_torch.ops.modulation import MODULATION_ORDERS

    qm = MODULATION_ORDERS[modulation]
    nre = min(156, nre_per_prb - xoh) * n_prb
    ninfo = nre * target_code_rate * qm * n_layers * tb_scaling
    if ninfo <= 0:
        return 0
    if ninfo <= 3824:
        n = max(3, int(np.floor(np.log2(ninfo))) - 6)
        ninfo_q = max(24, (1 << n) * int(ninfo / (1 << n)))
        return int(TBS_TABLE[np.searchsorted(TBS_TABLE, ninfo_q)])
    n = int(np.floor(np.log2(ninfo - 24))) - 5
    ninfo_q = max(3840, (1 << n) * int(round((ninfo - 24) / (1 << n))))
    if target_code_rate <= 0.25:
        c = int(np.ceil((ninfo_q + 24) / 3816))
        return 8 * c * int(np.ceil((ninfo_q + 24) / (8 * c))) - 24
    if ninfo_q > 8424:
        c = int(np.ceil((ninfo_q + 24) / 8424))
        return 8 * c * int(np.ceil((ninfo_q + 24) / (8 * c))) - 24
    return 8 * int(np.ceil((ninfo_q + 24) / 8)) - 24


@dataclass(frozen=True, eq=False)
class SCHConfig:
    """Static per-grant transport configuration (derived once per grant)."""

    a: int  # TB payload bits
    bg: int
    c: int  # code blocks
    z: int
    k: int  # bits per CB incl. fillers
    k_prime: int  # info+CRC bits per CB (K' = B'/C)
    n_filler: int
    qm: int
    n_layers: int
    g: int  # total coded bits for the grant
    tb_crc: str  # '24A' | '16'
    cb_crc: bool

    @property
    def e_per_cb(self) -> tuple:
        """§5.4.2.1 per-CB rate-matched lengths (floor/ceil split)."""
        c, g, qm, nl = self.c, self.g, self.qm, self.n_layers
        es = []
        for j in range(c):
            if j <= c - (g // (nl * qm) % c) - 1:
                es.append(nl * qm * (g // (nl * qm * c)))
            else:
                es.append(nl * qm * int(np.ceil(g / (nl * qm * c))))
        return tuple(es)


@lru_cache(maxsize=256)
def sch_config(a: int, target_code_rate: float, qm: int, n_layers: int, g: int) -> SCHConfig:
    """Segmentation parameters per §5.2.2/§5.3.2 (MATLAB nrDLSCHInfo analogue)."""
    bg = ldpc.select_base_graph(a, target_code_rate)
    tb_crc = "16" if a <= 3824 else "24A"
    b = a + crc_length(tb_crc)
    kcb = 8448 if bg == 1 else 3840
    if b <= kcb:
        c, b_prime, cb_crc = 1, b, False
    else:
        c = int(np.ceil(b / (kcb - 24)))
        b_prime = b + 24 * c
        cb_crc = True
    k_prime = int(np.ceil(b_prime / c))  # last CB zero-padded when C doesn't divide B'
    kb = ldpc.kb_for(bg, b)
    z = ldpc.select_lifting_size(kb, k_prime)
    k = (22 if bg == 1 else 10) * z
    return SCHConfig(
        a=a, bg=bg, c=c, z=z, k=k, k_prime=k_prime, n_filler=k - k_prime,
        qm=qm, n_layers=n_layers, g=g, tb_crc=tb_crc, cb_crc=cb_crc,
    )


def _cb_groups(cfg: SCHConfig) -> tuple:
    """Contiguous (start, count, e_bits) runs of equal rate-match length
    (§5.4.2.1 gives E- to the first CBs and E+ to the rest: at most 2 runs)."""
    es = cfg.e_per_cb
    groups = []
    i = 0
    while i < len(es):
        j = i
        while j < len(es) and es[j] == es[i]:
            j += 1
        groups.append((i, j - i, es[i]))
        i = j
    return tuple(groups)


def _rv_per_cb(rv):
    """rv for ldpc.rate_match/rate_recover: a per-grant tensor gets a trailing
    axis that broadcasts over the code blocks."""
    return rv[..., None] if torch.is_tensor(rv) else rv


def sch_encode(tb_bits: torch.Tensor, cfg: SCHConfig, rv) -> torch.Tensor:
    """TB payload [..., A] -> rate-matched codeword bits [..., G]."""
    assert tb_bits.shape[-1] == cfg.a
    rv = _rv_per_cb(rv)
    b = crc_attach(tb_bits, cfg.tb_crc)
    code = ldpc.lifted_code(cfg.bg, cfg.z)
    per_cb = cfg.k_prime - (24 if cfg.cb_crc else 0)
    pad = cfg.c * per_cb - b.shape[-1]
    if pad:
        b = torch.cat([b, b.new_zeros((*b.shape[:-1], pad))], dim=-1)
    cbs = b.reshape(*b.shape[:-1], cfg.c, per_cb)  # [..., C, per_cb]
    if cfg.cb_crc:
        cbs = crc_attach(cbs, "24B")
    if cfg.n_filler:
        cbs = torch.cat([cbs, cbs.new_zeros((*cbs.shape[:-1], cfg.n_filler))], dim=-1)
    cw = ldpc.encode(code, cbs)  # [..., C, n_full]
    outs = []
    for st, cnt, e_bits in _cb_groups(cfg):
        seg = ldpc.rate_match(cw[..., st:st + cnt, :], cfg.bg, cfg.z, e_bits, rv,
                              cfg.n_filler, cfg.k, cfg.qm)  # [..., cnt, E]
        outs.append(seg.reshape(*b.shape[:-1], cnt * e_bits))
    return torch.cat(outs, dim=-1)


def sch_decode(
    llrs: torch.Tensor,
    cfg: SCHConfig,
    rv,
    soft_buffers: torch.Tensor | None = None,
    n_iter: int = 6,
    schedule: str = "auto",
    impl: str | None = None,
):
    """Rate-matched LLRs [..., G] -> (tb_bits [..., A], tb_crc_ok [...] bool,
    soft_buffers [..., C, Ncb]).

    soft_buffers: [..., C, Ncb] HARQ combining state with the LLRs' leading
    axes, or [C, Ncb] shared by all of them (None = fresh process).
    LLR sign convention: positive = bit 0.

    schedule:
      'auto'/'layered' (default): layered normalized min-sum at n_iter, the
        reference's schedule. Every code block of every run and of every
        leading index goes through ONE decode_layered call (codewords decode
        independently); impl selects its implementation (see decode_layered).
      'flooding': fully-parallel flooding at n_iter with parity early exit
        (pass 2*n_iter for layered-equivalent BLER). One decode per
        rate-match run, and every leading index keeps its own stop, as the
        reference's per-run call under a vmap over grants: runs and grants
        are NOT merged into one exit decision, which would change the
        iteration count and with it the posterior."""
    code_n = (66 if cfg.bg == 1 else 50) * cfg.z
    if soft_buffers is None:
        soft_buffers = llrs.new_zeros((cfg.c, code_n), dtype=torch.float32)
    rv = _rv_per_cb(rv)
    offs = 0
    full_runs, buf_runs = [], []
    for st, cnt, e_bits in _cb_groups(cfg):
        seg = llrs[..., offs:offs + cnt * e_bits]
        offs += cnt * e_bits
        seg = seg.reshape(*llrs.shape[:-1], cnt, e_bits)
        full, buf = ldpc.rate_recover(seg, cfg.bg, cfg.z, rv, cfg.n_filler, cfg.k,
                                      cfg.qm, soft_buffer=soft_buffers[..., st:st + cnt, :])
        full_runs.append(full)
        buf_runs.append(buf)
    if schedule in ("auto", "layered"):
        hard, cb_ok = decode_layered(torch.cat(full_runs, dim=-2), cfg.bg, cfg.z,
                                     n_iter=n_iter, impl=impl)
    elif schedule == "flooding":
        outs = [ldpc._decode_flooding(full, cfg.bg, cfg.z, n_iter, 0.75, True, exit_dims=1)
                for full in full_runs]
        hard = torch.cat([o[0] for o in outs], dim=-2)
        cb_ok = torch.cat([o[1] for o in outs], dim=-1)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    hard = hard[..., : cfg.k_prime]  # [..., C, K']
    if cfg.cb_crc:
        cb_ok = cb_ok & crc_check(hard, "24B")
        hard = hard[..., :-24]
    b = hard.reshape(*llrs.shape[:-1], -1)
    tb = b[..., : cfg.a]
    tb_ok = crc_check(b[..., : cfg.a + crc_length(cfg.tb_crc)], cfg.tb_crc)
    tb_ok = tb_ok & torch.all(cb_ok, dim=-1)
    return tb, tb_ok, torch.cat(buf_runs, dim=-2)


# RV sequence on HARQ retransmission (updateHARQProcess.m:16-32)
RV_SEQUENCE = (0, 3, 2, 1)
