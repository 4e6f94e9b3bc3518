"""PDSCH / PUSCH full chains: transport + scrambling + modulation + layers +
precoding + DM-RS, and the matching receivers (counterpart of
isac_tpu/phy/chains.py).

The reference builds one program per grant and vmaps it over links or over
the same-layout grants of a slot; here the transmit and receive functions
carry an explicit leading axis instead (links in the batched link step,
grants in sch_transmit_batch / sch_receive_batch), and what the reference
traces per grant — scrambling sequence, DM-RS values, PRBs, rv, precoder,
soft buffers — is a tensor with that leading axis. The allocated PRBs form a
canonical compact grid [14, 12*n_prb], so every layout below (DM-RS combs,
data rows, estimation bundles, PRG pairing) is PRB-relative. When all items
share one allocation it is placed by a slice assignment (contiguous) or an
index assignment (RBG bitmaps); when they differ, by one scatter with a
per-item subcarrier index. Either puts the same values where the reference's
dynamic_update_slice / one-hot product puts them.

Scrambling sequences, DM-RS references and layout indices are uploaded once
per (key, device) and reused.

Each stage runs inside a span ``<pdsch|pusch>.<tx|rx>.<stage>``
(utils/tracing.py; pdsch for direction "DL", pusch for "UL"), so a traced
run splits its time by stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

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
from isac_tpu_torch.utils import tracing
from isac_tpu_torch.utils.device import resolve_device
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


# The device copies below stay allocated while cached, so their caches are
# sized for what one cell holds live and not for the host caches' 4096: a
# scrambling sequence per UE (one byte per coded bit: 0.1 MB for 68 PRB x 2
# layers x 64-QAM, 1.3 MB at most), DM-RS references per UE and slot of a
# frame (39 kB at 273 PRB).
@lru_cache(maxsize=256)
def _seq_dev(direction: str, rnti: int, n_id: int, g: int, device: torch.device):
    return torch.as_tensor(_scrambling_seq_cached(direction, rnti, n_id, g), device=device)


@lru_cache(maxsize=1024)
def _refs_dev(slot: int, n_id: int, prbs: tuple, dsyms: tuple, device: torch.device):
    return torch.as_tensor(_dmrs_refs_cached(slot, n_id, prbs, dsyms), device=device)


def _grant_constants(grant: SCHGrant, lay: dict, device: torch.device):
    """(scrambling sequence [G], DM-RS refs [n_dsym, 6*n_prb]) on the device,
    uploaded once per (grant identity, device)."""
    return (_seq_dev(grant.direction, grant.rnti, grant.n_id, lay["cfg"].g, device),
            _refs_dev(grant.slot, grant.n_id, grant.prbs, lay["dsyms"], device))


@lru_cache(maxsize=256)
def _layout_dev(key: tuple, device: torch.device) -> dict:
    """The layout's index arrays on the device (once per key and device)."""
    lay = _layout(key)
    return {
        "sym_idx": torch.as_tensor(lay["sym_idx"], device=device),
        "sc_idx": torch.as_tensor(lay["sc_idx"], device=device),
        "data_syms": torch.as_tensor(np.asarray(lay["data_syms"], np.int64), device=device),
    }


def layer_map(d: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Codeword symbols [..., n] -> layers [..., L, n/L] (TS 38.211 §7.3.1.3)."""
    n = d.shape[-1]
    return d.reshape(*d.shape[:-1], n // n_layers, n_layers).transpose(-1, -2)


def layer_demap(x: torch.Tensor) -> torch.Tensor:
    """[..., L, m] -> codeword [..., L*m]."""
    return x.transpose(-1, -2).reshape(*x.shape[:-2], -1)


def _dmrs_rows(refs: torch.Tensor, ports: tuple, n_sc_c: int) -> torch.Tensor:
    """DM-RS symbol rows [..., n_ports, n_dsym, n_sc_c] from base refs
    [..., n_dsym, 6*n_prb]: comb-2 interleave by stack + reshape, FD-OCC sign
    on odd m for odd ports."""
    occ = _layout_occ(n_sc_c // 12, refs.device)
    rows = []
    for port in ports:
        vals = refs if port % 2 == 0 else refs * occ
        z = torch.zeros_like(vals)
        pair = (vals, z) if port // 2 == 0 else (z, vals)
        rows.append(torch.stack(pair, dim=-1).reshape(*vals.shape[:-1], n_sc_c))
    return torch.stack(rows, dim=-3)


@lru_cache(maxsize=256)
def _layout_occ(n_prb: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array([1.0, -1.0] * (3 * n_prb), np.float32), device=device)


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


def _wideband_precode(layer_grid: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w [..., P, L] x layer_grid [..., L, 14, K] -> [..., P, 14, K] (the
    reference's einsum form; its unrolled multiply-add variant is a TPU-only
    branch with the same values)."""
    return torch.einsum("...pl,...lsk->...psk", w, layer_grid)


def canonical_prg_count(n_prb: int, prg_size: int = 2) -> int:
    return (n_prb + prg_size - 1) // prg_size


def _contig_start(prbs):
    """First PRB when all items share one contiguous allocation (prbs is a
    tuple, or a [N, n_prb] array of equal rows), else None."""
    p = np.asarray(prbs)
    row = p if p.ndim == 1 else p[0]
    if row.size > 0 and np.all(np.diff(row) == 1) and (p.ndim == 1 or np.all(p == row)):
        return int(row[0])
    return None


def _sc_full(prbs, device) -> torch.Tensor:
    """Subcarrier indices of a PRB set [n_prb] -> [12*n_prb], or of one set
    per item [N, n_prb] -> [N, 12*n_prb] (on the device, once per set)."""
    p = np.asarray(prbs, np.int64)
    return _sc_full_dev(p.tobytes(), p.shape, device)


@lru_cache(maxsize=256)
def _sc_full_dev(prbs_bytes: bytes, shape: tuple, device: torch.device) -> torch.Tensor:
    p = np.frombuffer(prbs_bytes, np.int64).reshape(shape)
    sc = (12 * p[..., :, None] + np.arange(12)).reshape(*p.shape[:-1], -1)
    return torch.as_tensor(sc, device=device)


def _stage(direction: str, name: str):
    return tracing.span(("pdsch." if direction == "DL" else "pusch.") + name)


def _make_tx_fn(key: tuple, w_kind: str = "prg"):
    """Transmit for a grant signature: fn(tb [N, A], seq [G] or [N, G], refs
    [n_dsym, 6*n_prb] or [N, ...], prbs, rv, w, extra=None) -> port grid
    [N, P, 14, n_sc_grid]; N is the link or grant axis.

    prbs: a tuple shared by all items, or an integer array [N, n_prb] with
    one allocation per item. rv: a Python int, or an integer tensor [N].
    w by w_kind: 'prg' [N, n_prg, P, L] canonical-PRG precoders (PDSCH),
    'wideband' [N, P, L] (PUSCH TPMI), 'none' ignored (layers == ports).
    extra: optional port-domain content added to every item's grid."""
    lay = _layout(key)
    (n_prb, sym_start, n_sym, mcs, mcs_table, n_layers, add_pos,
     n_sc_grid, direction, reserved) = key
    cfg, dsyms, n_sc_c = lay["cfg"], lay["dsyms"], lay["n_sc_c"]
    mod = mcs_info(mcs, mcs_table)[0]
    ports = dmrs_ports(n_layers)
    data_syms, full_rows = lay["data_syms"], lay["full_rows"]

    def fn(tb_bits, seq, refs, prbs, rv, w, extra=None):
        nl = tb_bits.shape[0]
        dev = tb_bits.device
        with _stage(direction, "tx.sch_encode"):
            coded = transport.sch_encode(tb_bits, cfg, rv)
        with _stage(direction, "tx.modulate_map"):
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
                ld = _layout_dev(key, dev)
                lg = x.new_zeros((nl, n_layers, 14, n_sc_c))
                lg[:, :, ld["sym_idx"], ld["sc_idx"]] = x
                lg = lg + _dmrs_port_grid(refs_n, ports, n_sc_c, dsyms)
        with _stage(direction, "tx.precode_place"):
            if w_kind == "none":
                pg = lg
            elif w_kind == "wideband":
                pg = _wideband_precode(lg, w)
            else:
                pg = _prg_precode_canonical(lg, w)
            full = pg.new_zeros((nl, pg.shape[1], 14, n_sc_grid))
            start = _contig_start(prbs)
            if start is not None:
                full[..., start * 12: start * 12 + n_sc_c] = pg
            else:  # any other allocation, shared or one per item: a single scatter
                idx = _sc_full(prbs, dev).reshape(-1, 1, 1, n_sc_c).expand(pg.shape)
                full.scatter_(-1, idx, pg)
            if extra is not None:
                full = full + extra
        return full

    return fn


def _make_rx_fn(key: tuple, n_ldpc_iter: int, impl: str | None = None):
    """Receive for a grant signature: fn(rx_grid [N, n_rx, 14, n_sc_grid],
    seq, refs, prbs, rv, soft_buffers=None) -> dict(tb, crc_ok, soft_buffers,
    sinr_db, noise_var) with a leading link/grant axis; seq, refs, prbs and
    rv as in _make_tx_fn, soft_buffers [N, C, Ncb] or None (fresh). impl
    selects the LDPC decoder (decode_layered)."""
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
    prg = 2 if direction == "DL" else n_prb  # UL precoding is wideband
    full_rows = lay["full_rows"]

    def fn(rx_grid, seq, refs, prbs, rv, soft_buffers=None):
        nl = rx_grid.shape[0]
        dev = rx_grid.device
        start = _contig_start(prbs)
        if start is not None:
            rx_c = rx_grid[..., start * 12: start * 12 + n_sc_c]
        else:
            idx = _sc_full(prbs, dev).reshape(-1, 1, 1, n_sc_c)
            rx_c = torch.gather(rx_grid, -1, idx.expand(nl, rx_grid.shape[1], 14, n_sc_c))
        refs_n = refs.expand(nl, *refs.shape[-2:])
        with _stage(direction, "rx.estimate"):
            h, nvar = estimate_channel_canonical(rx_c, refs_n, ports, dsyms, n_prb,
                                                 n_basis=n_basis, prg_prbs=prg)
        with _stage(direction, "rx.mmse"):
            eq, sinr = mmse_equalize(rx_c, h, nvar)  # [N, L, 14, n_sc_c]
        with _stage(direction, "rx.demod"):
            ld = _layout_dev(key, dev)
            if full_rows:
                data = eq.index_select(-2, ld["data_syms"]).reshape(nl, eq.shape[1], n_re)
                re_sinr = sinr.index_select(-2, ld["data_syms"]).reshape(nl, sinr.shape[1], n_re)
            else:
                data = eq[:, :, ld["sym_idx"], ld["sc_idx"]]
                re_sinr = sinr[:, :, ld["sym_idx"], ld["sc_idx"]]
            llr = demodulate_llr(data, 1.0 / torch.clamp_min(re_sinr, 1e-9), mod)
            llr = _relayer_llrs(llr.reshape(nl, -1), n_layers, qm, n_re)
            llr = descramble_llr(llr, seq)
            llr = torch.clamp(llr, -60.0, 60.0)
        with _stage(direction, "rx.sch_decode"):
            tb, ok, bufs = transport.sch_decode(llr, cfg, rv, soft_buffers,
                                                n_iter=n_ldpc_iter, impl=impl)
        mean_sinr = torch.mean(re_sinr.reshape(nl, -1), dim=-1)
        mean_sinr_db = 10.0 * torch.log10(torch.clamp_min(mean_sinr, 1e-9))
        return {"tb": tb, "crc_ok": ok, "soft_buffers": bufs,
                "sinr_db": mean_sinr_db, "noise_var": nvar}

    return fn


@lru_cache(maxsize=256)
def _tx_fn(key: tuple, w_kind: str):
    return _make_tx_fn(key, w_kind)


@lru_cache(maxsize=256)
def _rx_fn(key: tuple, n_ldpc_iter: int):
    return _make_rx_fn(key, n_ldpc_iter)


def _w_kind(w) -> str:
    return "none" if w is None else ("wideband" if w.ndim == 2 else "prg")


def _w_dev(w, device: torch.device) -> torch.Tensor:
    """A precoder (tensor or numpy, any complex width) as complex64 on the device."""
    return torch.as_tensor(w, device=device).to(torch.complex64)


def sch_transmit(
    tb_bits: torch.Tensor,
    grant: SCHGrant,
    w=None,
    prg_size: int = 2,
    extra_grid=None,
):
    """TB [A] -> precoded antenna-port grid [n_ports, 14, n_sc_grid], on the
    device of tb_bits.

    w: [n_prg, n_ports, n_layers] canonical-PRG precoders (PDSCH) or
    [n_ports, n_layers] wideband TPMI matrix (PUSCH), tensor or numpy. None =
    identity (layers == ports). DM-RS rides the same precoder (NR port
    convention). extra_grid: optional pre-filled port-domain content (e.g.
    CSI-RS) to add. Returns (grid, dict(tbs, g, cfg))."""
    lay = _layout(grant.layout_key())
    dev = tb_bits.device
    seq, refs = _grant_constants(grant, lay, dev)
    w_in = None if w is None else _w_dev(w, dev)[None]
    extra = None if extra_grid is None else torch.as_tensor(extra_grid, device=dev)
    fn = _tx_fn(grant.layout_key(), _w_kind(w))
    pg = fn(tb_bits[None], seq, refs, grant.prbs, int(grant.rv), w_in, extra)[0]
    return pg, {"tbs": lay["tbs"], "g": lay["cfg"].g, "cfg": lay["cfg"]}


def sch_receive(
    rx_grid: torch.Tensor,  # [n_rx, 14, n_sc_grid]
    grant: SCHGrant,
    soft_buffers: torch.Tensor | None = None,
    n_ldpc_iter: int = 6,
    prg_size: int = 2,
):
    """Receiver: DM-RS channel estimate (effective channel incl. precoder) ->
    MMSE -> LLR -> descramble -> SCH decode, on the device of rx_grid.

    soft_buffers: [C, Ncb] HARQ state of an earlier transmission (None =
    fresh). Returns dict: tb, crc_ok, soft_buffers, sinr_db (mean post-eq),
    noise_var, tbs. The LDPC decoder is the CUDA kernel on a CUDA tensor and
    its plain version on a CPU tensor."""
    lay = _layout(grant.layout_key())
    dev = rx_grid.device
    seq, refs = _grant_constants(grant, lay, dev)
    bufs = None if soft_buffers is None else torch.as_tensor(soft_buffers, device=dev)[None]
    fn = _rx_fn(grant.layout_key(), n_ldpc_iter)
    out = fn(rx_grid[None], seq, refs, grant.prbs, int(grant.rv), bufs)
    out = {k: v[0] for k, v in out.items()}
    out["tbs"] = lay["tbs"]
    return out


# ----------------------------------------------------------- batched (per-slot)


def _stack_grant_inputs(grants: list, device: torch.device):
    """Stacked per-grant inputs on the device: scrambling sequences [N, G] and
    DM-RS refs [N, n_dsym, 6*n_prb] (each uploaded once per grant identity),
    PRBs as a host array [N, n_prb], rv as a tensor [N] (or an int when all
    grants share it)."""
    lay = _layout(grants[0].layout_key())
    consts = [_grant_constants(g, lay, device) for g in grants]
    seq = torch.stack([c[0] for c in consts])
    refs = torch.stack([c[1] for c in consts])
    prbs = np.stack([np.asarray(g.prbs, np.int64) for g in grants])
    rvs = [int(g.rv) for g in grants]
    rv = rvs[0] if len(set(rvs)) == 1 else torch.as_tensor(rvs, device=device)
    return lay, seq, refs, prbs, rv


def _batch_device(items, device) -> torch.device:
    """The device of a batch call: that of the first tensor among items, else
    `device` (None means the card)."""
    for x in items:
        if torch.is_tensor(x):
            return x.device
    return resolve_device(device)


def sch_transmit_batch(
    tb_list: list, grants: list, w_list: list, reduce_sum: bool = True, device=None
) -> torch.Tensor:
    """Same-layout grants -> SUMMED port grid [n_ports, 14, n_sc_grid]
    (reduce_sum=True: all grants share the gNB antennas) or stacked per-grant
    grids [n_grants, n_ports, 14, K] (each grant rides its own UE's channel).

    All grants must share layout_key() and precoder kind (the caller
    groups); rv and PRBs may differ per grant. The sum is taken over the
    per-grant full-carrier grids, so overlapping allocations (MU-MIMO) add.
    TBs and precoders may be tensors or numpy; with numpy only, `device`
    says where to run (None means the card)."""
    key = grants[0].layout_key()
    dev = _batch_device(list(tb_list) + list(w_list), device)
    w_kind = "wideband" if w_list[0].ndim == 2 else "prg"
    _, seq, refs, prbs, rv = _stack_grant_inputs(grants, dev)
    tb = torch.stack([torch.as_tensor(t, device=dev) for t in tb_list])
    w = torch.stack([_w_dev(x, dev) for x in w_list])
    grids = _tx_fn(key, w_kind)(tb, seq, refs, prbs, rv, w)
    return torch.sum(grids, dim=0) if reduce_sum else grids


def grant_soft_buffer_shape(grant: SCHGrant) -> tuple:
    cfg = _layout(grant.layout_key())["cfg"]
    return (cfg.c, (66 if cfg.bg == 1 else 50) * cfg.z)


def sch_receive_batch(
    rx,  # stacked [M, n_rx, 14, K] (+ rx_indices) or a list of [n_rx, 14, K]
    grants: list,
    soft_buffers_list: list,  # per-grant [C, Ncb] or None (fresh)
    n_ldpc_iter: int = 6,
    rx_indices=None,
):
    """Batched receiver over same-layout grants, on the device of rx. Returns
    a dict whose values carry a leading grant axis; index [i] for grant i.
    Nothing is read back to the host, so callers can defer the sync to the
    HARQ-feedback due slot.

    rx may be a stacked tensor indexed per grant by rx_indices (e.g. the
    all-UE received grid) or a per-grant list. Fresh HARQ processes get zero
    soft buffers (the additive identity of rate recovery), so new and
    repeated transmissions share one batch. All code blocks of all grants go
    through one decode."""
    key = grants[0].layout_key()
    if rx_indices is None:
        rx_g = torch.stack(list(rx))
    else:
        idx = torch.as_tensor(np.asarray(rx_indices, np.int64), device=rx.device)
        rx_g = rx.index_select(0, idx)
    dev = rx_g.device
    lay, seq, refs, prbs, rv = _stack_grant_inputs(grants, dev)
    if all(b is None for b in soft_buffers_list):
        bufs = None
    else:
        zeros = torch.zeros(grant_soft_buffer_shape(grants[0]), dtype=torch.float32, device=dev)
        bufs = torch.stack([zeros if b is None else torch.as_tensor(b, device=dev)
                            for b in soft_buffers_list])
    out = _rx_fn(key, n_ldpc_iter)(rx_g, seq, refs, prbs, rv, bufs)
    out["tbs"] = lay["tbs"]
    return out


def _relayer_llrs(llr: torch.Tensor, n_layers: int, qm: int, n_re: int) -> torch.Tensor:
    """Per-layer LLR blocks [..., L*n_re*Qm] (layer-major) -> codeword order,
    which interleaves layers per symbol: position ((j*L + l)*Qm + b)."""
    lead = llr.shape[:-1]
    x = llr.reshape(*lead, n_layers, n_re, qm)
    return x.transpose(-3, -2).reshape(*lead, -1)
