"""PDSCH chain: transport + scrambling + modulation + layers + PRG precoding +
DM-RS, and the matching receiver (downlink part of isac_tpu/phy/chains.py).

The reference builds one program per grant and vmaps it over links; here the
transmit and receive functions carry an explicit leading link axis instead.
The allocated PRBs form a canonical compact grid [14, 12*n_prb], so every
layout below (DM-RS combs, data rows, estimation bundles, PRG pairing) is
PRB-relative. Contiguous allocations are placed by a slice assignment;
non-contiguous ones (RBG bitmaps) by an index assignment, which puts the same
values where the reference's one-hot product puts them.

Each stage runs inside a ``record_function("pdsch.<tx|rx>.<stage>")`` range,
so a torch.profiler trace of the real step splits its time by stage
(isac_tpu_torch/profile_link_step.py reads them).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch.profiler import record_function

from isac_tpu_torch.mac.tables import mcs_info
from isac_tpu_torch.ops import transport
from isac_tpu_torch.ops.channel_est import estimate_channel_canonical, mmse_equalize
from isac_tpu_torch.ops.dmrs import DMRS_SYMBOLS_TYPE_A, dmrs_values_for_prbs
from isac_tpu_torch.ops.modulation import (
    MODULATION_ORDERS,
    demodulate_llr,
    descramble_llr,
    modulate,
    pdsch_scrambling_cinit,
    pusch_scrambling_cinit,
)
from isac_tpu_torch.utils.sequences import gold_sequence


@dataclass(frozen=True, eq=False)
class SCHGrant:
    """Static per-grant config shared by the PDSCH and PUSCH chains."""

    rnti: int = 1
    n_id: int = 1  # cell / scrambling identity
    slot: int = 0
    prb_start: int = 0
    n_prb: int = 51
    sym_start: int = 0
    n_sym: int = 14
    mcs: int = 10
    mcs_table: str = "qam64"
    n_layers: int = 1
    dmrs_add_pos: int = 1
    rv: int = 0
    n_sc_grid: int = 612  # full carrier width
    direction: str = "DL"  # 'DL' | 'UL'
    # reserved REs per PRB: ((symbol, sc_offset_in_prb), ...) — e.g. CSI-RS
    reserved_per_prb: tuple = ()
    prb_set: tuple = ()  # non-contiguous allocation (RBG bitmap); overrides start/n_prb

    @property
    def prbs(self) -> tuple:
        if self.prb_set:
            return tuple(self.prb_set)
        return tuple(range(self.prb_start, self.prb_start + self.n_prb))

    @property
    def modulation(self) -> str:
        return mcs_info(self.mcs, self.mcs_table)[0]

    @property
    def code_rate(self) -> float:
        return mcs_info(self.mcs, self.mcs_table)[1]

    @property
    def qm(self) -> int:
        return MODULATION_ORDERS[self.modulation]

    def layout_key(self) -> tuple:
        """Everything that determines shapes (NOT positions/ids)."""
        return (
            len(self.prbs), self.sym_start, self.n_sym, self.mcs, self.mcs_table,
            self.n_layers, self.dmrs_add_pos, self.n_sc_grid,
            self.direction, self.reserved_per_prb,
        )


def dmrs_ports(n_layers: int) -> tuple:
    """Layer -> DM-RS antenna port mapping: layers 1-2 on ports (0, 2), one per
    CDM group on disjoint combs; ranks 3-4 add the OCC partners (1, 3)."""
    return ((0,), (0, 2), (0, 2, 1), (0, 2, 1, 3))[n_layers - 1]


def dmrs_symbols_for_duration(add_pos: int, sym_start: int, n_sym: int) -> tuple:
    """Mapping-type-A DM-RS positions clamped to the scheduled duration (the
    additional position moves in for short durations; a duration holding no
    type-A position gets a front-loaded DM-RS at its first symbol)."""
    end = sym_start + n_sym
    if add_pos == 0:
        base = (2,)
    elif add_pos == 1:
        l1 = 11 if end >= 13 else (9 if end >= 11 else 7)
        base = (2, l1)
    elif add_pos == 2:
        base = (2, 7, 11) if end >= 13 else (2, 6, 9)
    else:
        base = DMRS_SYMBOLS_TYPE_A[add_pos]
    out = tuple(s for s in base if sym_start <= s < end)
    return out if out else (sym_start,)


@lru_cache(maxsize=256)
def _layout(key: tuple):
    """Canonical (PRB-relative) RE layout for a grant signature: static numpy
    index arrays + transport config."""
    (n_prb, sym_start, n_sym, mcs, mcs_table, n_layers, add_pos,
     n_sc_grid, direction, reserved) = key
    dsyms = dmrs_symbols_for_duration(add_pos, sym_start, n_sym)
    n_sc_c = 12 * n_prb
    alloc = np.zeros((14, n_sc_c), bool)
    alloc[sym_start: sym_start + n_sym, :] = True
    for l in dsyms:
        alloc[l, :] = False  # numCDMGroupsWithoutData=2: no data on DM-RS syms
    for sym, off in reserved:
        alloc[sym, off::12] = False
    sym_idx, sc_idx = np.nonzero(alloc)
    n_re = sym_idx.shape[0]
    data_syms = tuple(int(s) for s in np.unique(sym_idx))
    full_rows = bool(np.all(alloc.sum(axis=1)[list(data_syms)] == n_sc_c))
    mod, rate, _ = mcs_info(mcs, mcs_table)
    tbs = transport.nr_tbs(mod, n_layers, n_prb, n_re // n_prb, rate)
    g = n_re * MODULATION_ORDERS[mod] * n_layers
    cfg = transport.sch_config(tbs, rate, MODULATION_ORDERS[mod], n_layers, g)
    return {
        "dsyms": dsyms,
        "sym_idx": sym_idx.astype(np.int64),
        "sc_idx": sc_idx.astype(np.int64),
        "n_re": n_re,
        "tbs": tbs,
        "cfg": cfg,
        "n_sc_c": n_sc_c,
        "data_syms": data_syms,
        "full_rows": full_rows,
    }


def grant_layout(grant: SCHGrant):
    return _layout(grant.layout_key())


def grant_tbs(grant: SCHGrant) -> int:
    return _layout(grant.layout_key())["tbs"]


@lru_cache(maxsize=4096)
def _scrambling_seq_cached(direction: str, rnti: int, n_id: int, g: int) -> np.ndarray:
    if direction == "DL":
        cinit = pdsch_scrambling_cinit(rnti, 0, n_id)
    else:
        cinit = pusch_scrambling_cinit(rnti, n_id)
    return gold_sequence(cinit, g)


def _scrambling_seq(grant: SCHGrant, g: int) -> np.ndarray:
    """Per-(rnti, n_id, g) Gold sequence (slot-independent c_init)."""
    return _scrambling_seq_cached(grant.direction, grant.rnti, grant.n_id, g)


@lru_cache(maxsize=4096)
def _dmrs_refs_cached(slot: int, n_id: int, prbs: tuple, dsyms: tuple) -> np.ndarray:
    return np.stack(
        [dmrs_values_for_prbs(slot, int(l), n_id, prbs) for l in dsyms]
    ).astype(np.complex64)


def _dmrs_refs(grant: SCHGrant, dsyms: tuple) -> np.ndarray:
    """Base DM-RS sequence values over the allocation [n_dsym, 6*n_prb]."""
    return _dmrs_refs_cached(grant.slot, grant.n_id, grant.prbs, dsyms)


def layer_map(d: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Codeword symbols [..., n] -> layers [..., L, n/L] (TS 38.211 §7.3.1.3)."""
    n = d.shape[-1]
    return d.reshape(*d.shape[:-1], n // n_layers, n_layers).transpose(-1, -2)


def _dmrs_rows(refs: torch.Tensor, ports: tuple, n_sc_c: int) -> torch.Tensor:
    """DM-RS symbol rows [..., n_ports, n_dsym, n_sc_c] from base refs
    [..., n_dsym, 6*n_prb]: comb-2 interleave by stack + reshape, FD-OCC sign
    on odd m for odd ports."""
    n_prb = n_sc_c // 12
    occ = torch.as_tensor(np.array([1.0, -1.0] * (3 * n_prb), np.float32), device=refs.device)
    rows = []
    for port in ports:
        vals = refs if port % 2 == 0 else refs * occ
        z = torch.zeros_like(vals)
        pair = (vals, z) if port // 2 == 0 else (z, vals)
        rows.append(torch.stack(pair, dim=-1).reshape(*vals.shape[:-1], n_sc_c))
    return torch.stack(rows, dim=-3)


def _dmrs_port_grid(refs: torch.Tensor, ports: tuple, n_sc_c: int, dsyms: tuple) -> torch.Tensor:
    """Canonical DM-RS layer grid [..., n_ports, 14, n_sc_c] (zero rows off the
    DM-RS symbols)."""
    rows = _dmrs_rows(refs, ports, n_sc_c)
    dpos = {s: i for i, s in enumerate(dsyms)}
    zero = torch.zeros_like(rows[..., 0, :])
    return torch.stack([rows[..., dpos[s], :] if s in dpos else zero for s in range(14)],
                       dim=-2)


def _prg_precode_canonical(layer_grid: torch.Tensor, w: torch.Tensor, prg_size: int = 2):
    """layer_grid [..., L, 14, 12*n_prb], w [..., n_prg, P, L] (canonical
    allocated-PRB pairs) -> port grid [..., P, 14, 12*n_prb]."""
    n_sc_c = layer_grid.shape[-1]
    w_sc = torch.repeat_interleave(w, 12 * prg_size, dim=-3)[..., :n_sc_c, :, :]
    return torch.einsum("...kpl,...lsk->...psk", w_sc, layer_grid)


def _is_contig(prbs) -> bool:
    p = np.asarray(prbs)
    return bool(p.size > 0 and np.all(np.diff(p) == 1))


def _sc_full(prbs: tuple, device) -> torch.Tensor:
    p = np.asarray(prbs, np.int64)
    return torch.as_tensor((12 * p[:, None] + np.arange(12)[None, :]).reshape(-1),
                           device=device)


def _make_tx_fn(key: tuple):
    """PDSCH transmit for a grant signature: fn(tb [N, A], seq [G], refs
    [n_dsym, 6*n_prb], prbs tuple, rv int, w [N, n_prg, P, L]) -> port grid
    [N, P, 14, n_sc_grid]; N is the link axis. (The reference's identity and
    wideband precoder kinds serve the uplink and are not ported yet.)"""
    lay = _layout(key)
    (n_prb, sym_start, n_sym, mcs, mcs_table, n_layers, add_pos,
     n_sc_grid, direction, reserved) = key
    cfg, dsyms, n_sc_c = lay["cfg"], lay["dsyms"], lay["n_sc_c"]
    mod = mcs_info(mcs, mcs_table)[0]
    ports = dmrs_ports(n_layers)
    data_syms, full_rows = lay["data_syms"], lay["full_rows"]

    def fn(tb_bits, seq, refs, prbs, rv, w):
        nl = tb_bits.shape[0]
        dev = tb_bits.device
        with record_function("pdsch.tx.sch_encode"):
            coded = transport.sch_encode(tb_bits, cfg, rv)
        with record_function("pdsch.tx.modulate_map"):
            d = modulate(coded, mod, scramble=seq)  # XOR folded into sign planes
            x = layer_map(d, n_layers)  # [N, L, n_re]
            refs_n = refs.expand(nl, *refs.shape[-2:])
            if full_rows:
                # fully-occupied data symbols: the grid is a reshape + row stack
                drows = _dmrs_rows(refs_n, ports, n_sc_c)  # [N, L, n_dsym, n_sc_c]
                dpos = {s: i for i, s in enumerate(dsyms)}
                data_pos = {s: i for i, s in enumerate(data_syms)}
                xd = x.reshape(nl, n_layers, len(data_syms), n_sc_c)
                zero = x.new_zeros((nl, n_layers, n_sc_c))
                rows = [
                    xd[:, :, data_pos[s]] if s in data_pos
                    else (drows[:, :, dpos[s], :] if s in dpos else zero)
                    for s in range(14)
                ]
                lg = torch.stack(rows, dim=-2)  # [N, L, 14, n_sc_c]
            else:
                lg = x.new_zeros((nl, n_layers, 14, n_sc_c))
                sym_idx = torch.as_tensor(lay["sym_idx"], device=dev)
                sc_idx = torch.as_tensor(lay["sc_idx"], device=dev)
                lg[:, :, sym_idx, sc_idx] = x
                lg = lg + _dmrs_port_grid(refs_n, ports, n_sc_c, dsyms)
        with record_function("pdsch.tx.precode_place"):
            pg = _prg_precode_canonical(lg, w)
            full = pg.new_zeros((nl, pg.shape[1], 14, n_sc_grid))
            if _is_contig(prbs):
                full[..., prbs[0] * 12: prbs[0] * 12 + n_sc_c] = pg
            else:
                full[..., _sc_full(prbs, dev)] = pg
        return full

    return fn


def _make_rx_fn(key: tuple, n_ldpc_iter: int, impl: str | None = None):
    """Receive for a grant signature: fn(rx_grid [N, n_rx, 14, n_sc_grid],
    seq, refs, prbs, rv) -> dict(tb, crc_ok, soft_buffers, sinr_db, noise_var)
    with a leading link axis. impl selects the LDPC decoder (decode_layered)."""
    lay = _layout(key)
    (n_prb, sym_start, n_sym, mcs, mcs_table, n_layers, add_pos,
     n_sc_grid, direction, reserved) = key
    cfg, dsyms, n_sc_c = lay["cfg"], lay["dsyms"], lay["n_sc_c"]
    n_re = lay["n_re"]
    mod = mcs_info(mcs, mcs_table)[0]
    qm = MODULATION_ORDERS[mod]
    ports = dmrs_ports(n_layers)
    # the scheduled MCS is the receiver's SNR proxy: more basis taps at high
    # MCS (low bias), fewer at low MCS (noise averaging)
    n_basis = 6 if mcs >= 8 else 3
    data_syms, full_rows = lay["data_syms"], lay["full_rows"]

    def fn(rx_grid, seq, refs, prbs, rv):
        nl = rx_grid.shape[0]
        dev = rx_grid.device
        if _is_contig(prbs):
            rx_c = rx_grid[..., prbs[0] * 12: prbs[0] * 12 + n_sc_c]
        else:
            rx_c = rx_grid[..., _sc_full(prbs, dev)]
        refs_n = refs.expand(nl, *refs.shape[-2:])
        with record_function("pdsch.rx.estimate"):
            h, nvar = estimate_channel_canonical(rx_c, refs_n, ports, dsyms, n_prb,
                                                 n_basis=n_basis)
        with record_function("pdsch.rx.mmse"):
            eq, sinr = mmse_equalize(rx_c, h, nvar)  # [N, L, 14, n_sc_c]
        with record_function("pdsch.rx.demod"):
            if full_rows:
                ds = torch.as_tensor(np.asarray(data_syms, np.int64), device=dev)
                data = eq.index_select(-2, ds).reshape(nl, eq.shape[1], n_re)
                re_sinr = sinr.index_select(-2, ds).reshape(nl, sinr.shape[1], n_re)
            else:
                sym_idx = torch.as_tensor(lay["sym_idx"], device=dev)
                sc_idx = torch.as_tensor(lay["sc_idx"], device=dev)
                data = eq[:, :, sym_idx, sc_idx]
                re_sinr = sinr[:, :, sym_idx, sc_idx]
            llr = demodulate_llr(data, 1.0 / torch.clamp_min(re_sinr, 1e-9), mod)
            llr = _relayer_llrs(llr.reshape(nl, -1), n_layers, qm, n_re)
            llr = descramble_llr(llr, seq)
            llr = torch.clamp(llr, -60.0, 60.0)
        with record_function("pdsch.rx.sch_decode"):
            tb, ok, bufs = transport.sch_decode(llr, cfg, rv, None, n_iter=n_ldpc_iter,
                                                impl=impl)
        mean_sinr = torch.mean(re_sinr.reshape(nl, -1), dim=-1)
        mean_sinr_db = 10.0 * torch.log10(torch.clamp_min(mean_sinr, 1e-9))
        return {"tb": tb, "crc_ok": ok, "soft_buffers": bufs,
                "sinr_db": mean_sinr_db, "noise_var": nvar}

    return fn


def _relayer_llrs(llr: torch.Tensor, n_layers: int, qm: int, n_re: int) -> torch.Tensor:
    """Per-layer LLR blocks [..., L*n_re*Qm] (layer-major) -> codeword order,
    which interleaves layers per symbol: position ((j*L + l)*Qm + b)."""
    lead = llr.shape[:-1]
    x = llr.reshape(*lead, n_layers, n_re, qm)
    return x.transpose(-3, -2).reshape(*lead, -1)
