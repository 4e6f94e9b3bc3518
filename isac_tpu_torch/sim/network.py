"""Network-level simulation (counterpart of isac_tpu/sim/network.py).

networkSimulation.m:1-235: validate the per-cell parameter maps, build the
scenario's city, resolve the line of sight of every link by ray-blockage tests
(topology/), run every cell and gather the network KPIs (ECDF data in place
of the reference's ECDF plots).

Co-channel cells run in LOCKSTEP, as in the JAX package (which exceeds the
reference here: its cells share nothing, networkSimulation.m:44-61): every
cell's DL port grid of a slot is built first, then each UE's receiver sums
its serving signal and every other co-channel cell's signal through a
cross-cell CDL / pathloss channel before its noise; each gNB's uplink
receiver likewise sums the other cells' co-channel PUSCH, through reciprocal
cross channels on a shared (TDD) carrier and through a separate UL-carrier
bank under FDD.

What is the reference's, bit for bit: the seeds (cell i: seed + i; bank d:
seed * 131 + d * 17; cross link (s, u): seed * 7919 + s * 100003 + u, plus
500009 on the FDD UL bank), the rectangular [S, U] banks whose self and
off-channel rows carry amplitude 0, the host float64 amplitudes and
pathlosses, and the due slots of every cell's results. What differs in form:

- The slot response of a bank is contracted per cluster delay, not per
  ray, in the channel layer's one form (`_RayBank` is an ops/cdl.py
  `SlotChannel`, as each engine's channel is): the frequency phases of each
  link's distinct delays are built once on the device in float64; each
  slot the slow-time phases, formed on the device in float64 from the
  Dopplers and symbol times kept there, are folded into the ray
  coefficients delay by delay, and one batched matrix product over the
  delays gives the response. A destination's DL cross term
  holds its bank's response for the slot only; the TDD uplink asks each bank
  for the one row it reads (`h_row`). The TPU device-phase branch
  (`_dev_path`), which forms those phases from float32 angles, is not
  ported.
- Every cell's due results come back in ONE device-to-host copy per network
  slot (`_materialize_all` over sim/cell.py `_readback`), in place of the
  reference's f32 bit-packed relay fetch; the due slots are the same.
- `mesh=` (a DeviceMesh with a `cell` dimension, parallel/mesh.py): the DL
  cross terms of every destination come from one `network_cross_rx` call per
  slot (parallel/cells.py), each rank contracting its block of destinations
  after one all_gather of the transmit grids; every rank runs every cell's
  engine. Cells that differ in shape cannot stack on the mesh axis and
  take the per-destination path, as in the reference; `mesh` is then None
  after the banks are built.

Spans (utils/tracing.py): ``build.cells`` (validation and the per-cell
parameters), ``build.los`` (the city and every line-of-sight test) and
``network.results`` (the ECDF gather) in `network_simulation`; in the
runner a ``network.slot`` span per slot, and inside it one span
``network.<stage>`` per stage (readback, dl_tx, dl_cross, dl_rx, ul_tx,
ul_cross, ul_rx, epilogue). The engine's own ``cell.*`` spans sit inside
them, and ``network.banks`` (a bank's build and slot response) inside the
cross stages that ask for it, with ``network.bank_h`` (device; attributes
``links``, ``subcarriers``, ``delays``, ``rays``, ``ports``) around the slot
response's device work, the fold and the contraction (the slot's time
phases are built just before it, counted as ``rays.device_time_phases``).
Each ``network.slot`` counts ``network.bank_bytes`` once: the runner's
``bank_bytes``, the most bytes the banks have held on the device at once
since they were built (constants and cached slot responses). A bank's build
draws its links inside the runner's stage ``network.bank_draws`` (host,
attribute ``links``; its seconds in ``stage_s["bank_draws"]``), and a DL
cross term's contraction runs inside ``network.dl_term`` (device; attributes
``sources``, ``ues``, ``subcarriers``, ``rx``, ``tx``).

Sectors: a link whose gNB is a sector's TRxP (`SectorGNBParams`) is drawn
with that gNB's element pattern, turned array and angles translated towards
the link's UE (ops/cdl.py `gnb_sector`), in the banks as in the engines: the
source's on a DL bank link, the destination's on an FDD UL bank link; the
TDD uplink reads the DL bank links by reciprocity.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from isac_tpu_torch.config.params import SimulationParameters, assign_cell_parameters
from isac_tpu_torch.metrics.kpi import ecdf
from isac_tpu_torch.ops.cdl import SlotChannel, build_cdl_link, gnb_sector, stack_links
from isac_tpu_torch.ops.pathloss import pathloss as pathloss_db
from isac_tpu_torch.parallel.cells import network_cross_rx
from isac_tpu_torch.sim.cell import CellSimulator, _readback
from isac_tpu_torch.topology.osm import build_city
from isac_tpu_torch.utils import tracing
from isac_tpu_torch.utils.geometry import BOLTZMANN, db2pow

def resolve_los(cells: list, sim: SimulationParameters) -> list:
    """The cell list with the LoS of every UE / target link resolved (the
    cross-cell pairs come from resolve_los_cross)."""
    cells, _ = resolve_los_cross(cells, sim)
    return cells


def resolve_los_cross(cells: list, sim: SimulationParameters):
    """Build the city (once, from the first cell's CityParams) and compute LoS
    booleans per UE / target link (networkSimulation.m generateScenario:79-115)
    and per cross-cell UE-gNB pair (openStreetMapCity.m:67-94 tests every
    antenna-UE pair). Returns (cells, cross_los) with cross_los[(dst_idx,
    src_idx)] = bool[n_ues_dst]; an empty dict without a city (cross links are
    then NLoS CDL-A)."""
    with tracing.span("build.los"):
        city = None
        for name in sim.city:
            city = build_city(sim.city[name], sim.roi)
            break
        if city is None:
            return cells, {}
        out = []
        cross_los: dict = {}
        for d, cell in enumerate(cells):
            gpos = np.asarray(cell.gnb.position, np.float64)
            ue_los = city.check_los(
                cell.ue_positions, np.broadcast_to(gpos, cell.ue_positions.shape)
            )
            if cell.target_positions.shape[0]:
                tg_los = city.check_los(
                    cell.target_positions,
                    np.broadcast_to(gpos, cell.target_positions.shape),
                )
            else:
                tg_los = np.ones(0, bool)
            out.append(cell.with_(ue_los=np.asarray(ue_los, bool),
                                  target_los=np.asarray(tg_los, bool)))
            for s, src in enumerate(cells):
                if s == d:
                    continue
                spos = np.asarray(src.gnb.position, np.float64)
                cross_los[(d, s)] = np.asarray(
                    city.check_los(
                        cell.ue_positions,
                        np.broadcast_to(spos, cell.ue_positions.shape),
                    ),
                    bool,
                )
        return out, cross_los


def _draws(stage, links: int):
    """The runner's ``bank_draws`` stage around a bank's link draws, or
    nothing for a bank built outside a runner."""
    return contextlib.nullcontext() if stage is None else stage("bank_draws", links=links)


class _RayBank(SlotChannel):
    """Every (source, UE) link of a destination as one batch of links in the
    cluster form (ops/cdl.py SlotChannel), on the destination engine's device
    and subcarriers.

    h(slot) is the whole response as [S, U, 14, K, rx, tx], kept for that
    slot until release(); h_row(slot, s) is source row s alone, computed on
    its own. The fold and the contraction of a response run inside the
    ``network.bank_h`` span, the slot's time phases just before it."""

    def _stack(self, links: list, dst_sim: CellSimulator):
        super().__init__(stack_links(links, device=dst_sim.dev), dst_sim.freqs, dst_sim._sym_t,
                         dst_sim.carrier.slot_duration_s)

    def h(self, slot: int) -> torch.Tensor:
        """[S, U, 14, K, rx, tx] for one slot (the DL cross term and the
        capture share it)."""
        h = super().h(slot)
        return h.reshape(self.n_cells, self.n_ues, *h.shape[1:])

    def h_row(self, slot: int, s: int) -> torch.Tensor:
        """h(slot)[s], [U, 14, K, rx, tx], computed alone and not kept (the
        TDD uplink reads one row of every other cell's bank)."""
        return self.response(slot, slice(s * self.n_ues, (s + 1) * self.n_ues))

    def _contract(self, ft: torch.Tensor, links) -> torch.Tensor:
        L, N, J, A = self.links.coeff[links].shape
        with tracing.span("network.bank_h", device=True, links=L, subcarriers=self.ffc.shape[1],
                          delays=N, rays=self.links.n_rays, ports=A):
            return super()._contract(ft, links)


class _UlCrossBank(_RayBank):
    """Non-reciprocal UL cross-cell CDL bank for FDD co-channel uplink:
    UE_{s,u} -> gNB_d links built ON THE UL CARRIER (TDD reuses the DL bank
    by reciprocity). Rectangular [S, U] layout like _CrossBank; rows of the
    destination itself, off-UL-channel sources or sources with another UE
    count carry active=False."""

    def __init__(self, dst_sim: CellSimulator, sims: list, dst_idx: int,
                 cross_los: dict, seed: int = 0, stage=None):
        dst = dst_sim.cell
        n_ues = max(s.n_ues for s in sims)
        self.n_cells = len(sims)
        self.n_ues = n_ues
        los_rows, pos_rows, active = [], [], []
        for s, src_sim in enumerate(sims):
            src = src_sim.cell
            active.append(
                s != dst_idx
                and src.gnb.ul_carrier_freq == dst.gnb.ul_carrier_freq
                and src_sim.n_sc == dst_sim.n_sc
                and src_sim.n_ues == n_ues
                and src_sim.n_ue_ants == sims[0].n_ue_ants
            )
            # LoS of (gNB_d, UE_{s,u}) = cross_los[(s, d)]: the blockage test
            # is direction-symmetric (openStreetMapCity.m:67-94)
            los = cross_los.get((s, dst_idx))
            los_rows.append(np.zeros(n_ues, bool) if los is None or len(los) != n_ues else los)
            pos_rows.append(src.ue_positions if src_sim.n_ues == n_ues
                            else np.zeros((n_ues, 3)))
        with _draws(stage, len(sims) * n_ues):
            links = [
                build_cdl_link(
                    src_sim.cell.cdl.delay_profile if los[u] else "CDL-A",
                    src_sim.cell.cdl.delay_spread_ns, dst.gnb.ul_carrier_freq,
                    src_sim.ue_elems, dst_sim.gnb_elems,
                    ue_velocity=src_sim.cell.cdl.max_doppler_shift_hz * src_sim.carrier.wavelength,
                    seed=seed * 7919 + s * 100003 + u + 500009,
                    sector=gnb_sector(dst.gnb, pos[u], "rx"),
                )
                for s, (src_sim, los, pos) in enumerate(zip(sims, los_rows, pos_rows))
                for u in range(n_ues)
            ]
        pl_rows = [pathloss_db(dst.pathloss.model, np.asarray(dst.gnb.position), pos,
                               dst.gnb.ul_carrier_freq, los)
                   for los, pos in zip(los_rows, pos_rows)]
        self._stack(links, dst_sim)
        self.active = np.asarray(active, bool)
        self.pl = np.stack(pl_rows)  # [S, U] dB at the UL carrier


class _CrossBank(_RayBank):
    """Batched cross-cell CDL bank: EVERY source gNB -> one destination
    cell's UEs in one batched channel (_RayBank). S = number of cells; the
    self and off-channel rows carry amplitude 0 and active=False (kept so
    that the shapes stay rectangular)."""

    def __init__(self, dst_sim: CellSimulator, sims: list, dst_idx: int,
                 cross_los: dict, seed: int = 0, stage=None):
        dst = dst_sim.cell
        n_ues = dst.ue_positions.shape[0]
        self.n_cells = len(sims)
        self.n_ues = n_ues
        self.dst_idx = dst_idx
        amp_rows, pl_rows = [], []
        scs_hz = dst.gnb.scs_khz * 1e3

        def teq(nf_db, t_k):
            return t_k + 290.0 * (db2pow(nf_db) - 1.0)

        n_re = BOLTZMANN * teq(dst.ue.noise_figure_db, dst.ue.temperature_k) * scs_hz
        active = [s != dst_idx
                  and src_sim.cell.gnb.dl_carrier_freq == dst.gnb.dl_carrier_freq
                  and src_sim.n_sc == dst_sim.n_sc
                  for s, src_sim in enumerate(sims)]
        # no city: cross links NLoS
        los_rows = [cross_los.get((dst_idx, s), np.zeros(n_ues, bool)) for s in range(len(sims))]
        with _draws(stage, len(sims) * n_ues):
            links = [
                build_cdl_link(
                    dst.cdl.delay_profile if los[u] else "CDL-A",
                    dst.cdl.delay_spread_ns, src_sim.cell.gnb.dl_carrier_freq,
                    src_sim.gnb_elems, dst_sim.ue_elems,
                    ue_velocity=dst.cdl.max_doppler_shift_hz * src_sim.carrier.wavelength,
                    seed=seed * 7919 + s * 100003 + u,
                    sector=gnb_sector(src_sim.cell.gnb, dst.ue_positions[u], "tx"),
                )
                for s, (src_sim, los) in enumerate(zip(sims, los_rows))
                for u in range(n_ues)
            ]
        for src_sim, los, on in zip(sims, los_rows, active):
            src = src_sim.cell
            # source tx power per RE through the source->UE pathloss, over the
            # DESTINATION receiver's noise floor (the serving amp_dl's units)
            pl = pathloss_db(
                dst.pathloss.model, np.asarray(src.gnb.position),
                dst.ue_positions, src.gnb.dl_carrier_freq, los,
            )
            pl_rows.append(pl)
            p_re = db2pow(src.gnb.tx_power_dbm - 30.0) / src_sim.n_sc
            g = db2pow(dst.ue.rx_gain_db - pl)
            amp_rows.append(np.sqrt(p_re * g / n_re) * (1.0 if on else 0.0))
        self._stack(links, dst_sim)
        self.active = np.asarray(active, bool)
        self.amp = np.stack(amp_rows).astype(np.float32)  # [S, U]
        self.pl = np.stack(pl_rows)  # [S, U] dB, reused by the UL cross budget


class SyncNetworkRunner:
    """Lockstep multi-cell run with co-channel DL + UL interference, one fused
    cross term per destination cell and slot, or, with a `mesh` (a DeviceMesh
    with a `cell` dimension) and shape-homogeneous cells, one sharded cross
    step for every destination per slot. `device` (None = the card) is every
    cell's.

    stage_s: host seconds spent in each stage (the names of the
    ``network.*`` spans) since construction, whether or not tracing records;
    ``banks`` (bank builds and slot responses) is also inside ``dl_cross`` /
    ``ul_cross``, and ``bank_draws`` (a bank build's link draws) inside
    ``banks``."""

    def __init__(self, cells: list, seed: int = 0, cross_los: dict | None = None,
                 mesh=None, ul_interference: bool = True, device=None, **cell_kwargs):
        self.sims = [
            CellSimulator(cell, seed=seed + i, device=device, **cell_kwargs)
            for i, cell in enumerate(cells)
        ]
        n_slots = {s.num_slots for s in self.sims}
        if len(n_slots) != 1:
            raise ValueError("lockstep interference needs equal num_slots per cell")
        self.num_slots = n_slots.pop()
        self.seed = seed
        self.cross_los = cross_los or {}
        self.mesh = mesh
        self.ul_interference = ul_interference
        self.banks: list | None = None  # built at the first run()
        self.ul_banks: list | None = None  # FDD only, built when first needed
        self._zero_grids: dict = {}
        self._net_rx = None  # the mesh's cross step, set by _build_banks
        self.stage_s: dict = {}
        self.bank_bytes = 0  # the most bytes the banks held on the device at once

    @contextlib.contextmanager
    def _stage(self, name: str, **attrs):
        """The ``network.<name>`` span, its host time added to stage_s."""
        with tracing.span(f"network.{name}", timed=True, **attrs) as sp:
            yield
        self.stage_s[name] = self.stage_s.get(name, 0.0) + sp.seconds

    def _build_banks(self):
        if self.banks is not None:
            return
        with self._stage("banks"):
            self.banks = [
                _CrossBank(sim, self.sims, d, self.cross_los,
                           seed=self.seed * 131 + d * 17, stage=self._stage)
                for d, sim in enumerate(self.sims)
            ]
        self._note_bank_bytes()
        if self.mesh is not None:
            shapes = {(s.n_sc, s.n_tx, s.n_ues, s.cell.gnb.dl_carrier_freq) for s in self.sims}
            if len(shapes) != 1:
                self.mesh = None  # heterogeneous cells cannot stack on the mesh axis
            else:
                self._net_rx = network_cross_rx(self.mesh)
                self._amp_all = torch.as_tensor(
                    np.stack([b.amp * b.active[:, None] for b in self.banks]),
                    device=self.sims[0].dev)  # [C_dst, C_src, U]

    def _note_bank_bytes(self):
        """Raise bank_bytes to what the banks hold on the device now."""
        held = sum(b.nbytes() for b in (self.banks or []) + (self.ul_banks or []))
        self.bank_bytes = max(self.bank_bytes, held)

    def _zero_grid(self, sim: CellSimulator) -> torch.Tensor:
        """The stand-in grid of a silent or off-channel source."""
        key = (sim.n_tx, sim.n_sc, sim.dev)
        if key not in self._zero_grids:
            self._zero_grids[key] = torch.zeros((sim.n_tx, 14, sim.n_sc), dtype=torch.complex64,
                                                device=sim.dev)
        return self._zero_grids[key]

    def _dl_ext(self, d: int, slot: int, states: list):
        """All co-channel sources -> cell d's UEs in one contraction:
        [n_ues, n_rx, 14, K], or None when no active source transmits."""
        bank = self.banks[d]
        present = np.asarray([st is not None for st in states], bool)
        mask = bank.active & present
        if not mask.any():
            return None
        tx = torch.stack([
            states[s]["port_grid"] if (states[s] is not None and bank.active[s])
            else self._zero_grid(self.sims[s])
            for s in range(len(self.sims))
        ])
        amp = torch.as_tensor(bank.amp * mask[:, None].astype(np.float32), device=bank.dev)
        with self._stage("banks"):
            h = bank.h(slot)
        self._note_bank_bytes()
        n_rx, n_tx = h.shape[-2:]
        with tracing.span("network.dl_term", device=True, sources=h.shape[0], ues=h.shape[1],
                          subcarriers=h.shape[3], rx=n_rx, tx=n_tx):
            return torch.einsum("xtsk,xuskat,xu->uask", tx, h, amp.to(torch.complex64))

    def _dl_ext_mesh(self, slot: int, states: list) -> torch.Tensor:
        """Every destination's DL cross term [C_dst, U, n_rx, 14, K] in one
        sharded step (silent sources carry a zero grid and amplitude 0)."""
        tx = torch.stack([st["port_grid"] if st is not None else self._zero_grid(self.sims[s])
                          for s, st in enumerate(states)])
        present = np.asarray([st is not None for st in states], np.float32)
        amp_all = self._amp_all * torch.as_tensor(present, device=self._amp_all.device)[None, :, None]
        with self._stage("banks"):
            h = torch.stack([b.h(slot) for b in self.banks])  # [C_dst, C_src, U, 14, K, rx, tx]
        self._note_bank_bytes()
        return self._net_rx(tx, h, amp_all)

    def _ensure_ul_banks(self):
        if self.ul_banks is None:
            with self._stage("banks"):
                self.ul_banks = [
                    _UlCrossBank(sim, self.sims, d, self.cross_los,
                                 seed=self.seed * 131 + d * 17, stage=self._stage)
                    for d, sim in enumerate(self.sims)
                ]

    def _ul_ext(self, d: int, slot: int, ul_states: list):
        """Sum of the other cells' co-channel uplinks at gNB d, [n_rx, 14, K],
        or None. TDD (shared carrier): the cross channel UE_{s,u} -> gNB_d is
        the transpose of the DL bank entry gNB_d -> UE_{s,u} (reciprocity),
        row d of cell s's bank (h_row). FDD: the non-reciprocal _UlCrossBank
        on the UL carrier."""
        dst = self.sims[d]
        tdd_reciprocal = dst.cell.gnb.ul_carrier_freq == dst.cell.gnb.dl_carrier_freq
        if not tdd_reciprocal:
            self._ensure_ul_banks()
        ext = None
        for s, src in enumerate(self.sims):
            st = ul_states[s]
            if s == d or st is None:
                continue
            items = st["all_items"]
            if tdd_reciprocal:
                if (not self.banks[s].active[d]
                        or src.cell.gnb.ul_carrier_freq != src.cell.gnb.dl_carrier_freq):
                    continue
                pl = self.banks[s].pl[d]  # bank of cell s holds pl[gNB_d -> UE_{s,u}]
            else:
                if not self.ul_banks[d].active[s]:
                    continue
                pl = self.ul_banks[d].pl[s]
            # UE tx power over its granted PRBs through UE -> gNB_d pathloss,
            # over gNB_d's UL noise floor
            amp = np.asarray(
                [
                    np.sqrt(
                        src.p_ul_w / (12.0 * len(g.prb_set))
                        * db2pow(dst.cell.gnb.rx_gain_db - pl[g.ue])
                        / dst.n_re_ul
                    )
                    for g, _, _, _ in items
                ],
                np.float32,
            )
            ue_idx = torch.as_tensor(np.asarray([g.ue for g, _, _, _ in items], np.int64),
                                     device=dst.dev)
            grids = torch.stack(st["all_grids"]) * torch.as_tensor(
                amp, device=dst.dev)[:, None, None, None]
            with self._stage("banks"):
                if tdd_reciprocal:
                    h = self.banks[s].h_row(slot, d)
                else:
                    h = self.ul_banks[d].h(slot)[s]
                    self._note_bank_bytes()
            # TDD: the DL entry gNB_d -> UE_{s,u} with its antenna axes swapped
            eq = "gtsk,gskta->ask" if tdd_reciprocal else "gtsk,gskat->ask"
            term = torch.einsum(eq, grids, h[ue_idx])
            ext = term if ext is None else ext + term
        return ext

    def _materialize_all(self, slot: int):
        """Every cell's due results in ONE device-to-host copy, each cell then
        handed its share in the order it listed them."""
        per_cell = [sim._collect_due(slot) for sim in self.sims]
        host = iter(_readback([x for _, leaves in per_cell for x in leaves]))
        for sim, (due, _) in zip(self.sims, per_cell):
            if due:
                sim._consume_due(slot, due, host)

    def run(self) -> list:
        self._build_banks()
        for slot in range(self.num_slots):
            with tracing.span("network.slot", slot=slot):
                with self._stage("readback"):
                    self._materialize_all(slot)
                    infos = [sim._slot_begin(slot, skip_materialize=True) for sim in self.sims]
                # 1) every co-channel cell's DL transmit grid first
                states = []
                with self._stage("dl_tx"):
                    for sim, info in zip(self.sims, infos):
                        n_dl = sim._dl_syms(info)
                        states.append(sim._dl_tx_phase(slot, n_dl, csi_slot=info["csi_slot"])
                                      if n_dl else None)
                # 2) each receiver: serving signal + the other cells' co-channel DL
                ext_all = None
                if self.mesh is not None and any(st is not None for st in states):
                    with self._stage("dl_cross"):
                        ext_all = self._dl_ext_mesh(slot, states)
                        for b in self.banks:
                            b.release()
                for d, (sim, info) in enumerate(zip(self.sims, infos)):
                    if states[d] is None:
                        continue
                    if ext_all is not None:
                        ext = ext_all[d]
                    else:
                        with self._stage("dl_cross"):
                            ext = self._dl_ext(d, slot, states)
                            self.banks[d].release()  # the uplink reads rows (h_row)
                    with self._stage("dl_rx"):
                        sim._dl_rx_phase(slot, info["csi_slot"], states[d], ext=ext)
                # 3) UL: every cell's granted uplinks first, then each gNB
                #    receives serving + other cells' co-channel UL
                ul_states = []
                with self._stage("ul_tx"):
                    for sim, info in zip(self.sims, infos):
                        n_ul = sim._ul_syms(info)
                        ul_states.append(sim._ul_tx_phase(slot, n_ul) if n_ul else None)
                for d, sim in enumerate(self.sims):
                    if ul_states[d] is None:
                        continue
                    with self._stage("ul_cross"):
                        ext = self._ul_ext(d, slot, ul_states) if self.ul_interference else None
                        if self.ul_banks is not None:
                            self.ul_banks[d].release()
                    with self._stage("ul_rx"):
                        sim._ul_rx_phase(slot, ul_states[d], ext=ext)
                # 4) BSR + SRS
                with self._stage("epilogue"):
                    for sim, info in zip(self.sims, infos):
                        sim._slot_epilogue(slot, info)
                tracing.count("network.bank_bytes", self.bank_bytes)
        return [sim.finalize() for sim in self.sims]


def _has_cochannel(cells: list) -> bool:
    freqs = [c.gnb.dl_carrier_freq for c in cells]
    return len(freqs) != len(set(freqs))


def network_simulation(
    sim: SimulationParameters,
    enable_parallel_sim: bool = False,
    seed: int = 0,
    interference: bool = True,
    mesh=None,
    device=None,
    **cell_kwargs,
) -> dict:
    """Run all configured cells on `device` (None = the card). Returns
    {"cells": [per-cell result], "network": aggregate KPIs}.

    When >= 2 cells share a DL carrier and `interference` is on, the cells
    run in LOCKSTEP with cross-cell DL + UL interference (SyncNetworkRunner);
    otherwise each runs alone, on a thread pool when enable_parallel_sim (the
    reference's parfeval, networkSimulation.m:44-61; each cell owns its key
    stream, so the results equal the sequential run's). `mesh` goes to the
    lockstep runner (SyncNetworkRunner)."""
    with tracing.span("build.cells"):
        sim.validate()
        cells = assign_cell_parameters(sim)
    cells, cross_los = resolve_los_cross(cells, sim)

    if interference and len(cells) > 1 and _has_cochannel(cells):
        results = SyncNetworkRunner(
            cells, seed=seed, cross_los=cross_los, mesh=mesh, device=device, **cell_kwargs
        ).run()
    else:
        def run_one(idx_cell):
            idx, cell = idx_cell
            return CellSimulator(cell, seed=seed + idx, device=device, **cell_kwargs).run()

        items = list(enumerate(cells))
        if enable_parallel_sim and len(items) > 1:
            with ThreadPoolExecutor(max_workers=min(len(items), 8)) as pool:
                results = list(pool.map(run_one, items))
        else:
            results = [run_one(it) for it in items]

    with tracing.span("network.results"):
        # network-level ECDF inputs (networkSimulation.m plotComMetricsECDF:173-232:
        # throughput, goodput and BLER surfaces, metricsVisualizer.m:627-674)
        def gather(key):
            return np.concatenate([r["communication"][key] for r in results])

        network = {
            "totalDLThroughputMbps": float(
                sum(r["communication"]["cellDLThroughputMbps"] for r in results)
            ),
            "totalULThroughputMbps": float(
                sum(r["communication"]["cellULThroughputMbps"] for r in results)
            ),
        }
        for label, key in (
            ("dlThroughputECDF", "ueDLThroughputMbps"),
            ("ulThroughputECDF", "ueULThroughputMbps"),
            ("dlGoodputECDF", "ueDLAppGoodputMbps"),
            ("ulGoodputECDF", "ueULAppGoodputMbps"),
            ("dlBLERECDF", "ueDLBLER"),
            ("ulBLERECDF", "ueULBLER"),
        ):
            network[label] = ecdf(gather(key))
    return {"cells": results, "network": network}
