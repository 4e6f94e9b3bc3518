"""Per-cell ISAC simulation engine (counterpart of isac_tpu/sim/cell.py).

The per-slot loop of cellSimulation.m:147-187: APP traffic -> RLC (UM or AM)
-> MAC (LCP, scheduler, HARQ, BSR, CSI feedback with k1 timing) -> PHY
(PDSCH / PUSCH chains over CDL fading and TR 38.901 pathloss) -> metrics, with
the DL grids of the frame feeding the mono-static sensing post-pass (radar
echo -> RDM -> CA-CFAR -> DoA -> RMSE, cellSimulation.m:189-202).

The control plane (scheduler, RLC, HARQ bookkeeping, byte-level PDUs) runs on
the host, the data plane on the engine's device, in noise-normalised units
(per-RE noise variance 1, grid amplitudes sqrt(per-RE SNR) from the link
budget), as in the reference. What differs in form:

- Results stay on the device until the slot their feedback is due (k1 for DL
  HARQ and CSI, the next slot for UL CRC and SRS); then every result due in
  that slot comes back in ONE device-to-host copy of their bytes
  (`_materialize_due`). The due slots, and so the trace, are the reference's.
- Every random draw is the reference's: the key of (seed, slot, salt) comes
  from numpy's SeedSequence on the host and `utils/prng.py` draws the same
  threefry normals as `jax.random` (bits exact, normals within ~2 ulps); on
  the card each draw, the post-pass's too, is one launch of its kernel.
- The channel of each direction is one batch of links in the cluster form
  (ops/cdl.py `SlotChannel`, as the network banks'): the frequency phases of
  the delays are built once on the device, each slot's time phases there
  too, both from float64, and one fold and batched product per slot and
  direction gives every UE's H, kept for the current slot. The reference's
  host float64 phases and ray contraction give the same H to float32
  summation order.
- The slot is split into phases (`_slot_begin`, `_dl_tx_phase`,
  `_dl_rx_phase(ext=)`, `_ul_tx_phase`, `_ul_rx_phase(ext=)`,
  `_slot_epilogue`) so that sim/network.py can run co-channel cells in
  lockstep and add other cells' signals before each receiver's noise. Each
  tx phase and the SRS are a host half (`_plan_dl`, `_plan_ul`,
  `_plan_srs`) and a device half (`_apply_dl_tx`, `_apply_ul_tx`,
  `_apply_srs`).
- Block mode (`block_slots >= 1`) runs the host halves ahead up to the next
  feedback boundary and then the segment's device halves (sim/block.py),
  with the slot loop's results bit for bit.
- `mesh=` computes the sensing RDM sharded over the mesh's `mesh_time_axis`
  (parallel/time_blocks.py).
- A sector's TRxP (config/params.py `SectorGNBParams`) draws its serving
  links with its element pattern, its turned array and its angles translated
  towards each UE at the gNB end (ops/cdl.py `gnb_sector`); an omni TRxP's
  links are drawn as the reference draws them.

Spans (utils/tracing.py): ``build.engine`` around the constructor (with
``build.engine.links``, the CDL draws, and ``build.engine.rays``, the links in
the cluster form, their upload and the device frequency phases), ``cell.slot``
around each slot of the slot loop, and inside it a span ``cell.<stage>`` for
every stage (tick, plan, dl_tx, dl_rx, ul_tx, ul_rx, csi, srs, due_readback;
segment around a block-mode segment's device work); ``cell.finalize`` (flush
and KPIs) and ``cell.sensing`` (the post-pass, its noise draw in
``sensing.noise``).
"""

from __future__ import annotations

import copy
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from isac_tpu_torch.app.traffic import make_traffic
from isac_tpu_torch.config.carrier import CarrierConfig
from isac_tpu_torch.config.params import CellParams
from isac_tpu_torch.mac.lcp import LCPState, LogicalChannel
from isac_tpu_torch.mac.pdu import build_mac_pdu, parse_mac_pdu
from isac_tpu_torch.mac.scheduler import Grant, Scheduler
from isac_tpu_torch.metrics.kpi import CellMetrics, peak_spectral_efficiency
from isac_tpu_torch.metrics.logger import MacPcapWriter, SchedulingLogger
from isac_tpu_torch.ops.cdl import (
    SlotChannel,
    build_cdl_link,
    gnb_sector,
    stack_links,
    subcarrier_freqs,
)
from isac_tpu_torch.ops.csi import (
    SINR_TO_CQI_UL,
    cqi_select,
    ri_select,
    subband_size,
    ul_tpmi_select,
)
from isac_tpu_torch.ops.csirs import (
    csirs_estimate_fdm,
    csirs_estimate_ports,
    csirs_fdm_reserved,
    csirs_fill_fdm,
    csirs_fill_grid,
)
from isac_tpu_torch.ops.pathloss import pathloss as pathloss_db
from isac_tpu_torch.ops.precoding import (
    panel_config_for_antenna,
    pusch_codebook,
    type1_codebook,
    type1_multipanel_codebook,
)
from isac_tpu_torch.ops.sensing import get_rmse
from isac_tpu_torch.ops.srs import srs_estimate_ports, srs_fill_grid
from isac_tpu_torch.phy.chains import (
    SCHGrant,
    grant_tbs,
    sch_receive_batch,
    sch_transmit_batch,
)
from isac_tpu_torch.phy.passthrough import CQIWalk, passthrough_crc
from isac_tpu_torch.rlc.am import AMEntity
from isac_tpu_torch.rlc.um import UMEntity
from isac_tpu_torch.sim.block import dispatch_segment
from isac_tpu_torch.sim.sensing import make_sensing_chain
from isac_tpu_torch.utils import prng, tracing
from isac_tpu_torch.utils.device import resolve_device
from isac_tpu_torch.utils.geometry import BOLTZMANN, db2pow

DEFAULT_LCID = 4  # setRLCChannelConfig.m:1-33 — single LC, LCID 4, LCG 1


def _readback(leaves: list) -> list:
    """Host numpy copies of a list of results in ONE device-to-host copy: the
    bytes of every tensor are concatenated on the device, copied once and cut
    apart on the host (exact for every dtype). Leaves that are already numpy
    (restored from a checkpoint) pass through."""
    out = [x if not torch.is_tensor(x) else None for x in leaves]
    ts = [(i, x.detach().contiguous()) for i, x in enumerate(leaves) if torch.is_tensor(x)]
    if not ts:
        return out
    buf = torch.cat([t.reshape(-1).view(torch.uint8) for _, t in ts]).cpu().numpy()
    off = 0
    for i, t in ts:
        nb = t.numel() * t.element_size()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[i] = np.frombuffer(buf[off: off + nb].tobytes(), dt).reshape(tuple(t.shape))
        off += nb
    return out


def _due_leaves(entries: list) -> list:
    """The results a list of deferred entries needs on the host, in the order
    _consume_due reads them (a share of batched receive outputs once)."""
    leaves: list = []
    seen_shares: list = []
    for e in entries:
        kind = e["kind"]
        if kind in ("dl", "ul"):
            sh = e["share"]
            if sh["np"] is None and not any(s is sh for s in seen_shares):
                seen_shares.append(sh)
                outs = sh["outs"]
                leaves += [outs["crc_ok"], outs["tb"], outs["sinr_db"]]
        elif kind == "csi":
            leaves.append(e["rank_dev"])
            for rep in e["reports"]:
                leaves += [rep["cqi_sb"], rep["pmi_sb"]]
        elif kind == "srs":
            leaves.append(e["rank_dev"])
            for tpmi, sdb in e["cands"]:
                leaves += [tpmi, sdb]
    return leaves


@dataclass
class _PendingFeedback:
    due_slot: int
    kind: str  # 'harq_dl' | 'csi'
    ue: int
    payload: dict


class CellSimulator:
    """One cell: gNB + UEs + targets. `run()` executes the full timeline on
    `device` (None means the card; raises without one).

    mesh: a DeviceMesh (parallel/mesh.py) whose `mesh_time_axis` dimension
    shards the FFT chain's range-Doppler map over symbol blocks; every rank
    runs the same engine. block_slots: 0 runs the slot loop; k >= 1 runs
    block mode with segments of at most k slots (1: one slot per segment).
    The sizes of the segments run are appended to `segment_lens`."""

    def __init__(
        self,
        cell: CellParams,
        seed: int = 0,
        n_rb_override: int | None = None,
        nfft_override: int | None = None,
        n_ldpc_iter: int = 6,
        rlc_mode: str = "UM",
        enable_sensing: bool = True,
        doa_method: str = "music",
        fast_csi: bool = False,
        phy_mode: str = "full",
        pcap_path: str | None = None,
        mesh=None,
        mesh_time_axis: str = "time",
        block_slots: int = 0,
        device=None,
    ):
        with tracing.span("build.engine", cell=cell.name):
            if phy_mode not in ("full", "passthrough"):
                raise ValueError(f"phy_mode must be 'full'|'passthrough', got {phy_mode!r}")
            self.dev = resolve_device(device)
            self.mesh = mesh
            self.mesh_time_axis = mesh_time_axis
            self.block_slots = int(block_slots)
            self.segment_lens: list = []
            self.cell = cell
            gnb = cell.gnb
            self.carrier = CarrierConfig(
                fc_hz=gnb.dl_carrier_freq,
                bandwidth_hz=gnb.dl_bandwidth,
                scs_khz=gnb.scs_khz,
                n_cell_id=gnb.cell_id,
                n_rb_override=n_rb_override,
                nfft_override=nfft_override,
            )
            self.info = self.carrier.ofdm
            self.tdd = gnb.tdd
            # FDD (schedulerEntity.m selectULSlotsToBeScheduledFDD:1482-1617):
            # paired spectrum, both directions active every slot
            self.fdd = gnb.duplex_mode == "FDD"
            self.symbol_sched = gnb.scheduling_type == "symbol"
            self.tti = cell.scheduling.tti_granularity
            if self.symbol_sched and self.tti not in (2, 4, 7):
                raise ValueError(f"tti_granularity must be 2/4/7, got {self.tti}")
            self.n_rb = self.carrier.n_rb
            self.n_sc = self.carrier.n_sc
            self._slots_per_ms = self.carrier.slots_per_frame // 10
            self.n_ues = cell.ue_positions.shape[0]
            self.num_slots = cell.num_slots
            self.n_ldpc_iter = n_ldpc_iter
            # pass-through PHY (gNBPassThroughPhy.m): statistical CRC, no
            # waveform, so no grid feeds the radar and sensing is off
            self.passthrough = phy_mode == "passthrough"
            self.enable_sensing = (
                enable_sensing and cell.target_positions.shape[0] > 0 and not self.passthrough
            )
            self.doa_method = doa_method
            self._seed = seed
            self.rng = np.random.default_rng(seed)

            self.n_tx = gnb.num_tx_ants
            self.n_ue_ants = cell.ue.num_ants
            lam = self.carrier.wavelength
            self.gnb_elems = gnb.antenna.element_positions(lam)
            # UE antenna: small ULA at 0.5 lambda (ueParameters.m geometry)
            ue_ant_y = np.arange(self.n_ue_ants) * 0.5 * lam
            self.ue_elems = np.stack(
                [np.zeros(self.n_ue_ants), ue_ant_y, np.zeros(self.n_ue_ants)], -1
            )

            # ---------------- link budget (noise-normalized units) ----------------
            # per-RE noise power N = k * Teq * SCS; per-RE signal power at the
            # receiver P_re * 10^((G_rx - PL)/10); grids carry amplitude
            # sqrt(SNR_re) so receiver-side noise has unit variance
            scs_hz = gnb.scs_khz * 1e3
            pl = pathloss_db(
                cell.pathloss.model,
                np.asarray(gnb.position),
                cell.ue_positions,
                gnb.dl_carrier_freq,
                cell.ue_los,
            )  # [n_ues]
            if cell.pathloss.shadow_fading:
                sf_rng = np.random.default_rng(cell.pathloss.seed * 997 + gnb.cell_id)
                pl = pl + sf_rng.normal(0.0, cell.pathloss.shadow_sigma_db, pl.shape)
            self.pathloss_db = pl

            def teq(nf_db, t_k):
                return t_k + 290.0 * (db2pow(nf_db) - 1.0)

            n_re_dl = BOLTZMANN * teq(cell.ue.noise_figure_db, cell.ue.temperature_k) * scs_hz
            n_re_ul = BOLTZMANN * teq(gnb.noise_figure_db, gnb.temperature_k) * scs_hz
            p_dl_re = db2pow(gnb.tx_power_dbm - 30.0) / self.n_sc  # W per RE
            self.p_ul_w = db2pow(cell.ue.tx_power_dbm - 30.0)
            g_dl = db2pow(cell.ue.rx_gain_db - pl)  # [n_ues]
            g_ul = db2pow(gnb.rx_gain_db - pl)
            self.amp_dl = np.sqrt(p_dl_re * g_dl / n_re_dl).astype(np.float32)  # [n_ues]
            self._amp_dl_dev = torch.as_tensor(self.amp_dl, device=self.dev)
            # UL amplitude depends on the granted bandwidth: P_ue / (12 * n_prb)
            self._g_ul_over_n = g_ul / n_re_ul
            self.n_re_ul = n_re_ul

            # ---------------- CDL fading links (host-precomputed constants) -------
            profiles = [
                cell.cdl.delay_profile if cell.ue_los[u] else "CDL-A" for u in range(self.n_ues)
            ]  # updateCDLModels.m: LoS -> CDL-D(config), NLoS -> CDL-A
            ue_speed = cell.cdl.max_doppler_shift_hz * lam  # fd = v / lambda
            with tracing.span("build.engine.links"):
                self.links_dl = [
                    build_cdl_link(
                        profiles[u], cell.cdl.delay_spread_ns, gnb.dl_carrier_freq,
                        self.gnb_elems, self.ue_elems, ue_velocity=ue_speed,
                        seed=cell.cdl.seed * 1000 + u,
                        sector=gnb_sector(gnb, cell.ue_positions[u], "tx"),
                    )
                    for u in range(self.n_ues)
                ]
                self.links_ul = [
                    build_cdl_link(
                        profiles[u], cell.cdl.delay_spread_ns, gnb.ul_carrier_freq,
                        self.ue_elems, self.gnb_elems, ue_velocity=ue_speed,
                        seed=cell.cdl.seed * 1000 + 500 + u,
                        sector=gnb_sector(gnb, cell.ue_positions[u], "rx"),
                    )
                    for u in range(self.n_ues)
                ]
            self.freqs = subcarrier_freqs(self.n_sc, scs_hz)
            self._sym_t = (
                self.info.symbol_starts(1, 0).astype(np.float64) / self.info.sample_rate
            )  # intra-slot symbol times [14]
            # each direction's links in the cluster form on the device, their
            # frequency phases built there once (ops/cdl.py SlotChannel)
            with tracing.span("build.engine.rays"):
                self._channel = {
                    d: SlotChannel(stack_links(links, device=self.dev), self.freqs, self._sym_t,
                                   self.carrier.slot_duration_s)
                    for d, links in (("DL", self.links_dl), ("UL", self.links_ul))
                }

            # ---------------- protocol state --------------------------------------
            sch = cell.scheduling
            self.scheduler = Scheduler(
                self.n_ues,
                self.n_rb,
                strategy=sch.strategy,
                mcs_table=sch.mcs_table,
                rbg_config=sch.rbg_size_config,
                n_harq=gnb.num_harq,
                pf_weight=sch.pf_moving_avg_weight,
                max_rb_per_ue=sch.rb_allocation_limit_dl,
                slot_duration_s=self.carrier.slot_duration_s,
                max_rank=min(4, self.n_ue_ants, self.n_tx),
            )
            mk_rlc = (lambda: AMEntity()) if rlc_mode == "AM" else (lambda: UMEntity())
            # two-ended bearer per UE: the gNB-end entity transmits DL SDUs and
            # receives UL PDUs + DL STATUS; the UE-end entity the reverse
            self.rlc_gnb = [mk_rlc() for _ in range(self.n_ues)]
            self.rlc_ue = [mk_rlc() for _ in range(self.n_ues)]
            self.lcp_dl = [self._mk_lcp() for _ in range(self.n_ues)]
            self.lcp_ul = [self._mk_lcp() for _ in range(self.n_ues)]
            tp = cell.traffic
            self.traffic_dl = [
                make_traffic(tp.model, True, tp, tp.seed * 100 + u) for u in range(self.n_ues)
            ]
            self.traffic_ul = [
                make_traffic(tp.model, False, tp, tp.seed * 100 + 50 + u)
                for u in range(self.n_ues)
            ]
            self.pending: list[_PendingFeedback] = []
            self.rx_soft_bufs: dict = {}  # ('DL'|'UL', ue, harq_id) -> decoder buffers
            self.sb_size = subband_size(self.n_rb)
            self._sb_of_re = (np.arange(self.n_rb) // self.sb_size).astype(np.int64)
            # rank cap = min(4, UE rx ants, gNB ports) (uePhy.m:899-906)
            self._max_rank = min(4, self.n_ue_ants, self.n_tx)
            # multi-panel UPAs report against the Type-1 multi-panel codebook
            # (dlPMISelect.m:345, TS 38.214 §5.2.2.2.2); others single-panel
            self.ng, self.n1, self.n2 = panel_config_for_antenna(gnb.antenna)
            self.fast_csi = fast_csi
            # PDSCH rate-matches around the transmitted CSI-RS REs on CSI-RS
            # slots: the row-5 resource for <= 4 ports, the FDM layout above
            self.csirs_row5 = self.n_tx <= 4
            if self.csirs_row5:
                self.csirs_reserved = ((5, 0), (5, 1), (6, 0), (6, 1))
            else:
                self.csirs_reserved = csirs_fdm_reserved(self.n_tx)
            self.csi_period = max(
                int(round(sch.csi_report_period_ms * 1e-3 / self.carrier.slot_duration_s)), 1
            )
            self.bsr_period = sch.bsr_periodicity_slots
            self.srs_due = [3 + u // 4 for u in range(self.n_ues)]  # setupSRS.m offsets
            # sampled RE positions of the fast_csi truth measurements
            self._csi_sc_dev = torch.as_tensor(np.arange(self.n_rb) * 12 + 6, device=self.dev)
            self._srs_sc_dev = torch.as_tensor(np.arange(0, self.n_sc, 12), device=self.dev)

            # ---------------- sensing accumulation --------------------------------
            if self.enable_sensing:
                # senTxGrid accumulation (gNBPhy.m:604-612), kept on the device per
                # DL slot until the post-pass; zeros on UL slots
                self._sen_slots: dict = {}  # slot -> [n_tx, n_sym, n_sc]
                self._sen_amp_law = np.float32(10 ** ((gnb.tx_power_dbm - 30) / 20.0))
            self._deferred: list = []  # device-side results awaiting their due slot
            self.rx_calls = 0  # sch_receive_batch calls made (one decoder launch each)
            self.metrics = CellMetrics(
                n_ues=self.n_ues,
                bandwidth_hz=gnb.dl_bandwidth,
                duration_s=self.num_slots * self.carrier.slot_duration_s,
            )
            self.sched_log = SchedulingLogger(self.num_slots, self.n_ues, self.n_rb)
            self.pcap = (
                MacPcapWriter(pcap_path, tdd=gnb.duplex_mode == "TDD") if pcap_path else None
            )
            self._cqi_walk = (
                CQIWalk(self.n_ues, self.n_rb, seed=seed + 17) if self.passthrough else None
            )

    # ------------------------------------------------------------------ setup

    def _mk_lcp(self) -> LCPState:
        st = LCPState()
        st.add(LogicalChannel(lcid=DEFAULT_LCID, priority=1))
        return st

    def _next_ul_slot(self, slot: int, min_gap: int = 2) -> int:
        """Earliest UL slot >= slot + min_gap (k1 semantics,
        schedulerEntity.m:2148-2171). FDD: every slot carries UL."""
        if self.fdd:
            return slot + min_gap
        for s in range(slot + min_gap, slot + min_gap + 2 * self.tdd.periodicity):
            if self.tdd.slot_type(s) == "U":
                return s
        return slot + min_gap

    def _ttis(self, n_sym_avail: int) -> list:
        """Slot -> TTI split for symbol-based scheduling with granularity
        {2,4,7} (proportionalFair.m:115-384). Slot-based: one full-length TTI.
        Sub-2-symbol tails are dropped (no room for DM-RS + data)."""
        if not self.symbol_sched:
            return [(0, n_sym_avail)]
        out = []
        s = 0
        while s < n_sym_avail:
            n = min(self.tti, n_sym_avail - s)
            if n >= 2:
                out.append((s, n))
            s += n
        return out

    def _slot_key(self, slot: int, salt: int) -> np.ndarray:
        """Deterministic per-(slot, salt) PRNG key, made on the host."""
        ss = np.random.SeedSequence([self._seed, slot, salt])
        return ss.generate_state(2).astype(np.uint32)

    def _noise(self, shape, key) -> torch.Tensor:
        return prng.complex_normal(key, tuple(shape), self.dev)

    # ------------------------------------------------------------- channel ops

    def _h_slot(self, slot: int, direction: str) -> torch.Tensor:
        """All-UE channel for one slot, [L, 14, n_sc, n_rx, n_tx], kept for
        the current slot of each direction."""
        return self._channel[direction].h(slot)

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.dev)

    # ---------------------------------------------------------------- MAC/RLC

    def _rlc_buffer(self, rlc) -> int:
        """Buffer status incl. a pending AM STATUS PDU (it needs grant bytes
        on the reverse link even when no data waits)."""
        n = rlc.buffer_status()
        if getattr(rlc, "status_trigger", False):
            n += 16
        return n

    def _build_tb(self, ue: int, direction: str, tbs_bits: int,
                  grant: Grant | None = None) -> tuple:
        """LCP + RLC PDUs + MAC multiplexing -> (tb_bits int8 array, sdu_bytes).

        The transmitting end's AM STATUS PDU (acknowledging the reverse
        direction's data) rides first in-band on the same logical channel."""
        tb_bytes = tbs_bits // 8
        rlc = (self.rlc_gnb if direction == "DL" else self.rlc_ue)[ue]
        lcp = (self.lcp_dl if direction == "DL" else self.lcp_ul)[ue]
        # conservative MAC subheader reserve: 3 bytes per ~1400-byte PDU + slack
        budget = max(tb_bytes - 3 * (2 + tb_bytes // 1400) - 2, 0)
        pdus = []
        if budget > 4 and hasattr(rlc, "status_pdu"):
            # budget-bounded STATUS: truncated ACK_SN-correctly, the trigger
            # stays armed for the remainder
            sp = rlc.status_pdu(budget=budget)
            if sp is not None:
                pdus.append(sp)
                budget -= len(sp)
        served = lcp.allocate(budget, {DEFAULT_LCID: rlc.buffer_status()})
        if budget > 0:
            pdus += rlc.send_pdus(served.get(DEFAULT_LCID, 0))
        sdus = [(DEFAULT_LCID, p) for p in pdus]
        pdu = build_mac_pdu(sdus, tb_bytes)
        if self.pcap is not None and grant is not None:
            # nrPCAPWriter path (gNBPhy.m logPackets:1082-1115)
            self.pcap.write(
                pdu, rnti=grant.rnti, ueid=ue, harq_id=grant.harq_id,
                frame=grant.slot // self.carrier.slots_per_frame,
                slot=grant.slot % self.carrier.slots_per_frame,
                is_dl=direction == "DL",
                t_s=grant.slot * self.carrier.slot_duration_s,
            )
        if direction == "DL":
            # the gNB sees its own queues instantly (node.m RLC<->MAC glue)
            self.scheduler.update_buffer(ue, "DL", self._rlc_buffer(rlc))
        bits = np.unpackbits(np.frombuffer(pdu, np.uint8))[:tbs_bits]
        return bits.astype(np.int8), sum(len(p) for p in pdus)

    def _deliver_tb(self, ue: int, direction: str, tb_bits: np.ndarray):
        """Receiver MAC/RLC at the peer end: parse the PDU, reassemble SDUs
        (in-band STATUS goes to the entity's TX side), count goodput."""
        by = np.packbits(np.asarray(tb_bits, np.uint8))
        parsed = parse_mac_pdu(bytes(by.tobytes()))
        rlc = (self.rlc_ue if direction == "DL" else self.rlc_gnb)[ue]
        for lcid, pdu in parsed["sdus"]:
            for sdu in rlc.receive_pdu(pdu):
                self.metrics.on_sdu_delivered(direction, ue, len(sdu))

    def _tick_1ms(self, ms: float = 1.0):
        """APP traffic generation + RLC/LCP timers (node.m advanceTimer:359-384)."""
        for u in range(self.n_ues):
            for pkt in self.traffic_dl[u].generate(ms):
                self.rlc_gnb[u].enqueue_sdu(pkt)
            for pkt in self.traffic_ul[u].generate(ms):
                self.rlc_ue[u].enqueue_sdu(pkt)
            self.lcp_dl[u].tick_1ms()
            self.lcp_ul[u].tick_1ms()
            self.rlc_gnb[u].tick_1ms()
            self.rlc_ue[u].tick_1ms()
            self.scheduler.update_buffer(u, "DL", self._rlc_buffer(self.rlc_gnb[u]))

    # --------------------------------------------------------------- feedback

    def _collect_due(self, slot: int):
        """Pop the deferred entries due by `slot` and list the results they
        need on the host."""
        due = [e for e in self._deferred if e["due"] <= slot]
        if not due:
            return [], []
        self._deferred = [e for e in self._deferred if e["due"] > slot]
        return due, _due_leaves(due)

    def _materialize_due(self, slot: int):
        """Bring every result whose protocol due slot has arrived to the host
        in one copy, and hand it to the control plane."""
        with tracing.span("cell.due_readback"):
            due, leaves = self._collect_due(slot)
            if not due:
                return
            host = iter(_readback(leaves))
        self._consume_due(slot, due, host)

    def _consume_due(self, slot: int, due: list, host):
        unpacked_shares: list = []
        for e in due:  # the same interleaved order as _due_leaves
            kind = e["kind"]
            if kind in ("dl", "ul"):
                sh = e["share"]
                if sh["np"] is None and not any(s is sh for s in unpacked_shares):
                    unpacked_shares.append(sh)
                    sh["np"] = {"crc_ok": next(host), "tb": next(host),
                                "sinr_db": next(host)}
            elif kind == "csi":
                e["rank_host"] = int(next(host))
                e["reports_host"] = [
                    {"cqi_sb": next(host).astype(np.int64),
                     "pmi_sb": next(host).astype(np.int64)}
                    for _ in e["reports"]
                ]
            elif kind == "srs":
                e["rank_host"] = int(next(host))
                e["cands_host"] = [(int(next(host)), next(host)) for _ in e["cands"]]
        for e in due:
            kind = e["kind"]
            if kind in ("dl", "ul"):
                g, share, i = e["g"], e["share"], e["i"]
                d = "DL" if kind == "dl" else "UL"
                ok = bool(share["np"]["crc_ok"][i])
                self.metrics.on_crc(d, g.ue, g.tbs, ok)
                self.sched_log.log_crc(g.slot, d, g.ue, ok)
                bkey = (d, g.ue, g.harq_id)
                if ok:
                    self._deliver_tb(g.ue, d, share["np"]["tb"][i])
                    self.rx_soft_bufs.pop(bkey, None)
                else:
                    # a slice of the batch's soft buffers, kept where they are
                    self.rx_soft_bufs[bkey] = share["outs"]["soft_buffers"][i]
                res = self.scheduler.harq_feedback(g.ue, d, g.harq_id, ok)
                if res == "drop":
                    self.metrics.on_harq_drop(d, g.ue)
                    self.rx_soft_bufs.pop(bkey, None)
                if self.cell.log.enable_traces:
                    self.metrics.log_slot(
                        g.slot, dir=d, ue=g.ue, mcs=g.mcs, n_prb=len(g.prb_set),
                        tbs=g.tbs, crc=ok,
                        sinr_db=float(share["np"]["sinr_db"][i]), rv=g.rv,
                    )
            elif kind == "csi":
                rank = e["rank_host"]
                rep = e["reports_host"][rank - 1]
                cqi_rb = rep["cqi_sb"][self._sb_of_re]
                self.scheduler.update_dl_csi(e["ue"], cqi_rb, rank, rep["pmi_sb"])
                self.sched_log.log_csi(slot, "DL", e["ue"], cqi_rb)
            elif kind == "srs":
                rank = e["rank_host"]
                tpmi, sinr_db_sb = e["cands_host"][rank - 1]
                cqi_sb = np.sum(
                    sinr_db_sb[..., None] >= SINR_TO_CQI_UL[None, :], axis=-1
                ).astype(np.int64)
                cqi_rb = cqi_sb[self._sb_of_re]
                self.scheduler.update_ul_csi(e["ue"], cqi_rb, rank, tpmi)
                self.sched_log.log_csi(slot, "UL", e["ue"], cqi_rb)

    def _process_due(self, slot: int):
        due = [p for p in self.pending if p.due_slot <= slot]
        self.pending = [p for p in self.pending if p.due_slot > slot]
        for p in due:
            if p.kind == "harq_dl":
                res = self.scheduler.harq_feedback(
                    p.ue, "DL", p.payload["harq_id"], p.payload["ack"]
                )
                if res == "drop":
                    self.metrics.on_harq_drop("DL", p.ue)
                    self.rx_soft_bufs.pop(("DL", p.ue, p.payload["harq_id"]), None)
            elif p.kind == "csi":
                self.scheduler.update_dl_csi(
                    p.ue, p.payload["cqi_rb"], p.payload["rank"], p.payload["pmi_sb"]
                )
                self.sched_log.log_csi(slot, "DL", p.ue, p.payload["cqi_rb"])

    # ------------------------------------------------------------------- CSI

    def _csi_all(self, h: torch.Tensor) -> tuple:
        """Rank + the CQI/PMI report of every candidate rank, on the device."""
        rank = ri_select(h, 1.0, max_rank=self._max_rank)
        reports = tuple(
            {k: rep[k] for k in ("cqi_sb", "pmi_sb")}
            for rep in (cqi_select(h, 1.0, r, self.n1, self.n2,
                                   subband_of_re=self._sb_of_re, ng=self.ng)
                        for r in range(1, self._max_rank + 1))
        )
        return rank, reports

    def _srs_all(self, h: torch.Tensor) -> tuple:
        """Rank + the (TPMI, subband SINR) of every candidate rank."""
        rank = ri_select(h, 1.0, max_rank=self._max_rank)
        cands = tuple(
            ul_tpmi_select(h, 1.0, r, subband_of_re=self._sb_of_re)
            for r in range(1, self._max_rank + 1)
        )
        return rank, cands

    def _queue_csi(self, ue: int, slot: int, h_meas: torch.Tensor):
        """Rank/PMI/CQI selection on a per-PRB channel measurement [n_rb, n_rx,
        n_ports], left on the device; the report reaches the scheduler at its
        out-of-band due slot (ueMAC.m:747-768)."""
        rank_dev, reports = self._csi_all(h_meas)
        self._deferred.append({
            "due": self._next_ul_slot(slot), "kind": "csi", "ue": ue,
            "rank_dev": rank_dev, "reports": reports,
        })

    def _meas_noise(self, direction: str, ue: int, slot: int, sc: torch.Tensor,
                    amp, salt: int, sym: int) -> torch.Tensor:
        """fast_csi truth-channel sampling + estimation noise."""
        h = self._h_slot(slot, direction)[ue, sym][sc] * float(amp)
        return h + self._noise(h.shape, self._slot_key(slot, salt))

    def _csirs_measure(self, ue: int, slot: int):
        """fast_csi path: measured channel = truth at CSI-RS REs + estimation
        noise at the per-RE SNR."""
        h_meas = self._meas_noise("DL", ue, slot, self._csi_sc_dev,
                                  np.float32(self.amp_dl[ue]), 1000 + ue, 2)
        self._queue_csi(ue, slot, h_meas)

    def _csirs_measure_rx(self, ue: int, rx_all: torch.Tensor, slot: int):
        """UE-side CSI-RS measurement from the received grid (uePhy.m:757-933):
        LS at the transmitted CSI-RS REs -> rank/PMI/CQI."""
        if self.csirs_row5:
            h_meas, _ = csirs_estimate_ports(
                rx_all, slot % self.carrier.slots_per_frame,
                self.cell.gnb.cell_id, self.n_rb, row=5, ue_index=ue,
            )
        else:
            h_meas = csirs_estimate_fdm(
                rx_all, slot % self.carrier.slots_per_frame,
                self.cell.gnb.cell_id, self.n_rb, self.n_tx, ue_index=ue,
            )
        self._queue_csi(ue, slot, h_meas)

    def _srs_csi_update(self, ue: int, slot: int, h_meas: torch.Tensor):
        """Deferred like _queue_csi: UL CSI reaches the scheduler one slot
        after the sounding slot (gNB-local processing delay)."""
        rank_dev, cands = self._srs_all(h_meas)
        self._deferred.append({
            "due": slot + 1, "kind": "srs", "ue": ue,
            "rank_dev": rank_dev, "cands": cands,
        })

    def _srs_measure(self, ue: int, slot: int):
        """fast_csi path: truth + noise at sampled SRS REs."""
        amp = np.sqrt(self.p_ul_w / (self.n_sc / 4.0) * self._g_ul_over_n[ue]).astype(
            np.float32
        )
        h_meas = self._meas_noise("UL", ue, slot, self._srs_sc_dev, amp, 2000 + ue, 13)
        self._srs_csi_update(ue, slot, h_meas)

    def _plan_srs(self, ues: list) -> dict:
        """Host half of a slot's SRS: the sounding UEs, and for the
        transmitted-SRS path their grids + amplitudes (setupSRS.m comb
        offsets); fast_csi needs no grid."""
        if self.fast_csi:
            return {"ues": list(ues), "fast": True}
        grids = []
        amps = []
        for u in ues:
            g = np.zeros((self.n_ue_ants, 14, self.n_sc), np.complex64)
            g, _ = srs_fill_grid(g, self.n_rb, symbol=13, comb=4, comb_offset=u % 4)
            grids.append(g)
            amps.append(np.sqrt(self.p_ul_w / (self.n_sc / 4.0) * self._g_ul_over_n[u]))
        return {"ues": list(ues), "grids": np.stack(grids),
                "amps": np.asarray(amps, np.float32)}

    def _apply_srs(self, slot: int, plan: dict):
        """Device half of a slot's SRS. Transmitted-SRS path (gNBPhy.m
        srsRxProcessing:983-1062): every sounding UE's comb-4 SRS rides symbol
        13, the gNB receives the SUM and estimates each UE from its comb."""
        if plan.get("fast"):
            for u in plan["ues"]:
                self._srs_measure(u, slot)
            return
        ues = plan["ues"]
        h_sel = self._h_slot(slot, "UL")[self._to_dev(np.asarray(ues, np.int64))]
        grids = self._to_dev(plan["grids"]) * self._to_dev(plan["amps"])[:, None, None, None]
        rx = torch.einsum("gtsk,gskat->ask", grids, h_sel)
        rx = rx + self._noise(rx.shape, self._slot_key(slot, 2500))
        for u in ues:
            h_prb, _ = srs_estimate_ports(
                rx, self.n_rb, self.n_ue_ants, symbol=13, comb=4,
                comb_offset=u % 4, per_prb=True,
            )  # [n_rb, n_rx_gnb, n_ue_ports]
            self._srs_csi_update(u, slot, h_prb)

    # ----------------------------------------------------------------- grants

    def _dl_precoder(self, grant: Grant) -> np.ndarray:
        """Per-canonical-PRG precoders from the reported subband PMI
        (selectRankAndPrecodingMatrixDL, schedulerEntity.m:2482-2546); no
        report yet -> layer-to-port identity."""
        if not grant.pmi_sb:
            return np.eye(self.n_tx, grant.n_layers, dtype=np.complex64)
        if self.ng > 1:
            cb = type1_multipanel_codebook(self.ng, self.n1, self.n2, grant.n_layers)
        else:
            cb = type1_codebook(self.n1, self.n2, grant.n_layers)
        pmi_sb = np.asarray(grant.pmi_sb, np.int64) % cb.shape[0]
        prbs = np.asarray(grant.prb_set, np.int64)
        first_prb = prbs[0::2]  # canonical PRG anchors
        prg_to_sb = np.minimum(first_prb // self.sb_size, len(pmi_sb) - 1)
        return cb[pmi_sb[prg_to_sb]]  # host [n_prg, n_ports, L]

    def _sch_grant(self, g: Grant, n_sym: int, reserved: tuple = ()) -> SCHGrant:
        return SCHGrant(
            rnti=g.rnti,
            n_id=self.cell.gnb.cell_id,
            slot=g.slot % self.carrier.slots_per_frame,
            prb_set=tuple(g.prb_set),
            n_prb=len(g.prb_set),
            sym_start=g.sym_start,
            n_sym=n_sym,
            mcs_table=self.scheduler.mcs_table,
            mcs=g.mcs,
            n_layers=g.n_layers,
            rv=g.rv,
            n_sc_grid=self.n_sc,
            direction=g.direction,
            reserved_per_prb=reserved,
        )

    # -------------------------------------------------------------- slot steps

    def _prepare_tx(self, g: Grant, harq, n_sym: int, reserved: tuple = ()):
        """The exact grant layout + TB payload of one grant, or None if the
        grant is infeasible (e.g. a retransmission whose stored TB no longer
        fits the layout: dropped, HARQ process freed). The scheduler's TBS
        uses the reference's DM-RS overhead approximation; the exact RE
        layout decides the TB size."""
        stored = harq.payload.get((g.ue, g.harq_id))
        if g.is_retx and stored is not None:
            g.n_layers = stored["n_layers"]
            g.pmi_sb = stored.get("pmi_sb", g.pmi_sb)
            g.tpmi = stored.get("tpmi", g.tpmi)
        sg = self._sch_grant(g, n_sym, reserved)
        true_tbs = grant_tbs(sg)
        if true_tbs <= 0:
            if not g.is_retx:
                # the scheduler already claimed the process: free it
                harq.feedback(g.ue, g.harq_id, ack=True)
            return None
        if g.is_retx and stored is not None:
            if int(stored["tb"].shape[0]) != true_tbs:
                # layout changed across slot formats; abandon this HARQ process
                harq.feedback(g.ue, g.harq_id, ack=True)
                self.rx_soft_bufs.pop((g.direction, g.ue, g.harq_id), None)
                self.metrics.on_harq_drop(g.direction, g.ue)
                return None
            g.tbs = true_tbs
            return sg, stored["tb"]
        g.tbs = true_tbs
        harq.tbs[g.ue, g.harq_id] = true_tbs
        tb, _ = self._build_tb(g.ue, g.direction, true_tbs, grant=g)
        harq.payload[(g.ue, g.harq_id)] = {
            "tb": tb, "n_layers": g.n_layers, "pmi_sb": g.pmi_sb, "tpmi": g.tpmi,
        }
        return sg, tb

    def _passthrough_slot(self, slot: int, direction: str, n_sym: int):
        """Statistical PHY slot (gNBPassThroughPhy.m): the same scheduler /
        HARQ / RLC path, CRC by a Bernoulli draw from the CQI/MCS margin, no
        device work."""
        grants = self.scheduler.schedule_slot(slot, direction, n_sym=n_sym)
        harq = self.scheduler.harq_dl if direction == "DL" else self.scheduler.harq_ul
        for g in grants:
            prep = self._prepare_tx(g, harq, n_sym)
            if prep is None:
                continue
            _, tb = prep
            self.metrics.on_tx(direction, g.ue, g.tbs, g.is_retx)
            self.sched_log.log_grant(
                slot, direction, g.ue, g.prb_set, g.mcs, g.tbs, g.rv,
                g.harq_id, g.n_layers, g.is_retx,
            )
            u = self.scheduler.ues[g.ue]
            cqi = u.dl_cqi_rb if direction == "DL" else u.ul_cqi_rb
            avg_cqi = float(np.mean(cqi[list(g.prb_set)]))
            ok = passthrough_crc(
                self.rng, g.mcs, avg_cqi,
                int(harq.tx_count[g.ue, g.harq_id]), self.scheduler.mcs_table,
            )
            self.metrics.on_crc(direction, g.ue, g.tbs, ok)
            self.sched_log.log_crc(slot, direction, g.ue, ok)
            if ok:
                self._deliver_tb(g.ue, direction, np.asarray(tb))
            if direction == "DL":
                self.pending.append(
                    _PendingFeedback(
                        due_slot=self._next_ul_slot(slot), kind="harq_dl",
                        ue=g.ue, payload={"harq_id": g.harq_id, "ack": ok},
                    )
                )
            else:
                res = self.scheduler.harq_feedback(g.ue, "UL", g.harq_id, ok)
                if res == "drop":
                    self.metrics.on_harq_drop("UL", g.ue)

    def _dl_tx_phase(self, slot: int, n_sym: int, csi_slot: bool = False):
        """Schedule + build this cell's transmitted port grid. Returns a state
        dict {groups, port_grid, n_sym} for _dl_rx_phase, or None when the slot
        carries nothing. Split so that a network runner can collect every
        co-channel cell's grid before any receiver runs."""
        plan = self._plan_dl(slot, n_sym, csi_slot)
        if plan is None:
            return None
        return self._apply_dl_tx(plan)

    def _plan_dl(self, slot: int, n_sym: int, csi_slot: bool = False):
        """Host half of the DL tx phase: scheduling, TB building, the CSI-RS
        grid. Returns a plan dict for _apply_dl_tx, or None for passthrough
        (handled inline)."""
        with tracing.span("cell.plan"):
            if self.passthrough:
                self._passthrough_slot(slot, "DL", n_sym)
                if csi_slot:
                    # emulated CQI variation (uePassThroughPhy.m), via the
                    # normal out-of-band report path with k1 latency
                    for u in range(self.n_ues):
                        self.pending.append(
                            _PendingFeedback(
                                due_slot=self._next_ul_slot(slot), kind="csi", ue=u,
                                payload={
                                    "cqi_rb": self._cqi_walk.report(u), "rank": 1,
                                    "pmi_sb": np.zeros(max(self.n_rb // 4, 1), np.int32),
                                },
                            )
                        )
                return None
            harq = self.scheduler.harq_dl
            reserved = self.csirs_reserved if (csi_slot and not self.fast_csi) else ()
            # same-layout grants form one batched transmit/receive; symbol
            # scheduling splits the slot into TTIs that share the slot grid
            groups: dict = {}
            for ss, ns in self._ttis(n_sym):
                for g in self.scheduler.schedule_slot(slot, "DL", n_sym=ns, sym_start=ss):
                    prep = self._prepare_tx(g, harq, ns, reserved)
                    if prep is None:
                        continue
                    sg, tb = prep
                    w = self._dl_precoder(g)
                    wk = "wideband" if w.ndim == 2 else "prg"
                    groups.setdefault((sg.layout_key(), wk), []).append((g, sg, tb, w))
                    self.metrics.on_tx("DL", g.ue, g.tbs, g.is_retx)
                    self.sched_log.log_grant(
                        slot, "DL", g.ue, g.prb_set, g.mcs, g.tbs, g.rv, g.harq_id,
                        g.n_layers, g.is_retx, sym_start=ss, n_sym=ns,
                    )
            csirs_np = None
            if csi_slot and not self.fast_csi:
                if self.csirs_row5:
                    g0 = np.zeros((self.n_tx, 14, self.n_sc), np.complex64)
                    g0, _ = csirs_fill_grid(
                        g0, slot % self.carrier.slots_per_frame,
                        self.cell.gnb.cell_id, self.n_rb, row=5,
                    )
                    csirs_np = g0
                else:
                    csirs_np = csirs_fill_fdm(
                        slot % self.carrier.slots_per_frame, self.cell.gnb.cell_id,
                        self.n_rb, self.n_tx, self.n_sc,
                    )
        return {"slot": slot, "n_sym": n_sym, "csi_slot": csi_slot,
                "groups": groups, "csirs_np": csirs_np}

    def _sen_amp(self, n_sym: int) -> np.float32:
        """Sensing accumulation amplitude law (gNBPhy.m:592)."""
        return self._sen_amp_law * np.float32(
            np.sqrt(self.info.nfft**2 / (self.n_sc * self.n_tx))
        )

    def _apply_dl_tx(self, plan: dict):
        """Device half of the DL tx phase: every group's transmit summed into
        one port grid, plus the CSI-RS."""
        slot, n_sym, csi_slot = plan["slot"], plan["n_sym"], plan["csi_slot"]
        groups = plan["groups"]
        port_grid = None
        with tracing.span("cell.dl_tx"):
            for items in groups.values():
                grid_u = sch_transmit_batch(
                    [tb for _, _, tb, _ in items],
                    [sg for _, sg, _, _ in items],
                    [w for _, _, _, w in items],
                    device=self.dev,
                )
                port_grid = grid_u if port_grid is None else port_grid + grid_u
            if plan["csirs_np"] is not None:
                # the CSI-RS rides the same grid: PDSCH rate-matches around it,
                # the UEs estimate from it and the sensing accumulator gets
                # full-rank port excitation (uePhy.m:757-933; gNBPhy.m:583-588)
                csirs = self._to_dev(plan["csirs_np"])
                port_grid = csirs if port_grid is None else port_grid + csirs
        if port_grid is None:
            if csi_slot and self.fast_csi:  # truth-based CSI needs no grid
                with tracing.span("cell.csi"):
                    for u in range(self.n_ues):
                        self._csirs_measure(u, slot)
            return None
        if self.enable_sensing:
            self._sen_slots[slot] = port_grid[:, :n_sym, :] * float(self._sen_amp(n_sym))
        return {"groups": groups, "port_grid": port_grid, "n_sym": n_sym}

    def _dl_rx_phase(self, slot: int, csi_slot: bool, st: dict,
                     ext: torch.Tensor | None = None):
        """Receive every UE's grid (serving signal + optional external term
        `ext` [n_ues, n_rx, 14, n_sc], e.g. other cells' co-channel DL, added
        before the noise) and decode this cell's grants."""
        groups, port_grid = st["groups"], st["port_grid"]
        with tracing.span("cell.dl_rx"):
            # all UEs' received grids at once: [n_ues, n_rx, 14, n_sc]
            rx_all = torch.einsum("tsk,lskat->lask", port_grid, self._h_slot(slot, "DL"))
            rx_all = rx_all * self._amp_dl_dev[:, None, None, None]
            if ext is not None:
                rx_all = rx_all + ext
            rx_all = rx_all + self._noise(rx_all.shape, self._slot_key(slot, 7))
            for items in groups.values():
                gs = [g for g, _, _, _ in items]
                sgs = [sg for _, sg, _, _ in items]
                bufs = [
                    self.rx_soft_bufs.get(("DL", g.ue, g.harq_id)) if g.is_retx else None
                    for g in gs
                ]
                outs = sch_receive_batch(
                    rx_all, sgs, bufs, n_ldpc_iter=self.n_ldpc_iter,
                    rx_indices=[g.ue for g in gs],
                )
                self.rx_calls += 1
                # results stay on the device until the ACK/NACK due slot
                # (ueMAC.m:590-613 k1 timing)
                share = {"outs": outs, "np": None}
                for i, g in enumerate(gs):
                    self._deferred.append({
                        "due": self._next_ul_slot(slot), "kind": "dl", "g": g,
                        "share": share, "i": i,
                    })
        if csi_slot:
            # every UE measures CSI this slot, granted or not
            with tracing.span("cell.csi"):
                for u in range(self.n_ues):
                    if self.fast_csi:
                        self._csirs_measure(u, slot)
                    else:
                        self._csirs_measure_rx(u, rx_all, slot)

    def _ul_slot(self, slot: int, n_sym: int):
        """Single-cell UL slot = tx phase then rx phase (no interference)."""
        st = self._ul_tx_phase(slot, n_sym)
        if st is not None:
            self._ul_rx_phase(slot, st)

    def _ul_tx_phase(self, slot: int, n_sym: int):
        """Schedule + build every granted UE's UL port grid. Returns
        {groups, all_items, all_grids} for _ul_rx_phase, or None."""
        plan = self._plan_ul(slot, n_sym)
        if plan is None:
            return None
        return self._apply_ul_tx(plan)

    def _plan_ul(self, slot: int, n_sym: int):
        """Host half of the UL tx phase: scheduling + TB building. Returns
        {slot, groups} or None (nothing granted / passthrough inline)."""
        with tracing.span("cell.plan"):
            if self.passthrough:
                self._passthrough_slot(slot, "UL", n_sym)
                return None
            harq = self.scheduler.harq_ul
            groups: dict = {}
            for ss, ns in self._ttis(n_sym):
                for g in self.scheduler.schedule_slot(slot, "UL", n_sym=ns, sym_start=ss):
                    prep = self._prepare_tx(g, harq, ns)
                    if prep is None:
                        continue
                    sg, tb = prep
                    self.metrics.on_tx("UL", g.ue, g.tbs, g.is_retx)
                    self.sched_log.log_grant(
                        slot, "UL", g.ue, g.prb_set, g.mcs, g.tbs, g.rv, g.harq_id,
                        g.n_layers, g.is_retx, sym_start=ss, n_sym=ns,
                    )
                    cb = pusch_codebook(self.n_ue_ants, g.n_layers)
                    w = cb[g.tpmi % cb.shape[0]]  # host
                    groups.setdefault(sg.layout_key(), []).append((g, sg, tb, w))
        if not groups:
            return None
        return {"slot": slot, "groups": groups}

    def _apply_ul_tx(self, plan: dict):
        """Device half of the UL tx phase: per-grant port grids (batched
        within a layout group)."""
        groups = plan["groups"]
        all_items, all_grids = [], []
        with tracing.span("cell.ul_tx"):
            for items in groups.values():
                all_items.extend(items)
                all_grids.extend(sch_transmit_batch(
                    [tb for _, _, tb, _ in items],
                    [sg for _, sg, _, _ in items],
                    [w for _, _, _, w in items],
                    reduce_sum=False, device=self.dev,
                ))
        return {"groups": groups, "all_items": all_items, "all_grids": all_grids}

    def _ul_rx_phase(self, slot: int, st: dict, ext: torch.Tensor | None = None):
        """Receive all granted uplinks (+ optional external co-channel UL term
        ext [n_rx, 14, n_sc], seen by every grant's receiver, added before the
        noise) and decode."""
        groups, all_items, all_grids = st["groups"], st["all_items"], st["all_grids"]
        with tracing.span("cell.ul_rx"):
            h_all = self._h_slot(slot, "UL")
            ue_idx = self._to_dev(np.asarray([g.ue for g, _, _, _ in all_items], np.int64))
            # UE power concentrates on the granted PRBs (P_ue / n_alloc_re)
            amps = np.asarray(
                [
                    np.sqrt(self.p_ul_w / (12.0 * len(g.prb_set)) * self._g_ul_over_n[g.ue])
                    for g, _, _, _ in all_items
                ],
                np.float32,
            )
            rx_all = torch.einsum("gtsk,gskat->gask", torch.stack(all_grids), h_all[ue_idx])
            rx_all = rx_all * self._to_dev(amps)[:, None, None, None]
            if ext is not None:
                rx_all = rx_all + ext[None]
            rx_all = rx_all + self._noise(rx_all.shape, self._slot_key(slot, 9))
            pos = 0
            for items in groups.values():
                gs = [g for g, _, _, _ in items]
                sgs = [sg for _, sg, _, _ in items]
                bufs = [
                    self.rx_soft_bufs.get(("UL", g.ue, g.harq_id)) if g.is_retx else None
                    for g in gs
                ]
                outs = sch_receive_batch(
                    rx_all, sgs, bufs, n_ldpc_iter=self.n_ldpc_iter,
                    rx_indices=list(range(pos, pos + len(gs))),
                )
                self.rx_calls += 1
                pos += len(gs)
                # UL CRC is gNB-local (gNBMAC handleULRxResult): one-slot
                # processing delay before it shapes the next decision
                share = {"outs": outs, "np": None}
                for i, g in enumerate(gs):
                    self._deferred.append({
                        "due": slot + 1, "kind": "ul", "g": g,
                        "share": share, "i": i,
                    })

    # --------------------------------------------------------------- sensing

    def run_sensing(self) -> dict:
        """Post-pass: accumulated DL grids -> echo -> RDM -> CFAR -> DoA ->
        RMSE (cellSimulation.m:189-202). The echo's AWGN is the reference's
        draw under the key of (seed, 10**6, 0). With a mesh, the FFT chain's
        RDM is the time-block-sharded map."""
        cell = self.cell
        algo = cell.gnb.radar.est_algorithm.upper()
        if algo not in ("FFT", "MUSIC"):
            raise ValueError(f"est_algorithm must be FFT|MUSIC, got {algo!r}")
        with tracing.span("cell.sensing"):
            starts = tuple(sorted(self._sen_slots))
            widths = tuple(int(self._sen_slots[st].shape[1]) for st in starts)
            chain, params = make_sensing_chain(
                cell.gnb, self.carrier, cell.target_positions,
                np.asarray(cell.target.rcs_m2, np.float64),
                np.asarray(cell.target.velocity_ms, np.float64),
                self.num_slots, starts, widths,
                target_los=np.asarray(cell.target_los, bool),
                algo=algo, doa_method=self.doa_method, device=self.dev,
                mesh=self.mesh, mesh_axis=self.mesh_time_axis,
            )
            n = int(self.info.symbol_lengths_slots(self.num_slots).sum())
            sigma = float(np.float32(np.sqrt(params.n0 / 2.0)))
            with tracing.span("sensing.noise", device=True):
                noise = prng.complex_normal(self._slot_key(10**6, 0), (n, self.n_tx),
                                            self.dev, scale=sigma)
            est = chain([self._to_dev(self._sen_slots[st]) for st in starts], noise)
            del noise
            small = [k for k in ("rngEst", "velEst", "aziEst", "eleEst") if k in est]
            est_host = dict(est)
            est_host.update(zip(small, _readback([est[k] for k in small])))
        rmse = get_rmse(est_host, params)
        return {"estimates": est, "rmse": rmse, "params": params}

    # ------------------------------------------------------------- slot pieces

    def _slot_begin(self, slot: int, skip_materialize: bool = False) -> dict:
        """Timers, due feedback, slot typing, SRS counters: the per-slot
        prologue a network runner runs per cell before any tx phase.

        skip_materialize: the network runner has already brought this cell's
        due results to the host, in its one readback of every cell's
        (sim/network.py SyncNetworkRunner._materialize_all)."""
        if slot % self._slots_per_ms == 0:
            with tracing.span("cell.tick"):
                self._tick_1ms()
        if not skip_materialize:
            self._materialize_due(slot)
        self._process_due(slot)
        stype = "D" if self.fdd else self.tdd.slot_type(slot)
        ul_capable = self.fdd or stype in ("U", "S")
        # CSI-RS period [5 2] (setupCSIRS.m): DL slots with slot % 5 == 2
        csi_slot = stype == "D" and slot % self.csi_period == 2 % self.csi_period
        # periodic SRS (setupSRS.m): staggered per-UE counters
        sounding: list = []
        if ul_capable:
            for u in range(self.n_ues):
                self.srs_due[u] -= 1
                if self.srs_due[u] <= 0:
                    sounding.append(u)
                    self.srs_due[u] = 8
        return {"stype": stype, "ul_capable": ul_capable,
                "csi_slot": csi_slot, "sounding": sounding}

    def _dl_syms(self, info: dict) -> int:
        """DL symbols available this slot (0 = no DL)."""
        if self.fdd or info["stype"] == "D":
            return 14
        if info["stype"] == "S" and self.tdd.num_dl_syms >= 4:
            return self.tdd.num_dl_syms
        return 0

    def _ul_syms(self, info: dict) -> int:
        """UL symbols available this slot (0 = no UL). PUSCH avoids the SRS
        symbol when someone sounds."""
        if self.fdd or info["stype"] == "U":
            return 13 if (info["sounding"] and not self.fast_csi) else 14
        return 0

    def _slot_finish(self, slot: int, info: dict):
        """UL slot work + BSR + SRS: the per-slot epilogue."""
        n_ul = self._ul_syms(info)
        if n_ul:
            self._ul_slot(slot, n_ul)
        self._slot_epilogue(slot, info)

    def _slot_epilogue(self, slot: int, info: dict):
        """BSR + SRS (after any UL rx phase)."""
        self._epilogue_bsr(slot, info)
        sounding = info["sounding"]
        if sounding:
            self._epilogue_srs(slot, sounding)

    def _epilogue_bsr(self, slot: int, info: dict):
        """BSR host updates (ueMAC.m bsrTx:1102)."""
        if info["ul_capable"]:
            for u in range(self.n_ues):
                if slot % self.bsr_period == 0 or self.scheduler.ues[u].ul_buffer == 0:
                    self.scheduler.update_buffer(u, "UL", self._rlc_buffer(self.rlc_ue[u]))

    def _epilogue_srs(self, slot: int, sounding: list):
        if not sounding:
            return
        with tracing.span("cell.srs"):
            if self.passthrough:
                for u in sounding:  # emulated UL CQI walk
                    cqi = self._cqi_walk.report(u)
                    self.scheduler.update_ul_csi(u, cqi, 1, 0)
                    self.sched_log.log_csi(slot, "UL", u, cqi)
            else:
                self._apply_srs(slot, self._plan_srs(sounding))

    def finalize(self, sensing: bool = True) -> dict:
        """Flush deferred results and assemble the result dict (the tail of
        run(); a network runner calls it after the lockstep slot loop).
        sensing=False leaves the post-pass out (its result is then None), for
        a caller that times run_sensing() on its own."""
        with tracing.span("cell.finalize"):
            self._materialize_due(self.num_slots + 10**6)
            self._process_due(self.num_slots + 10**6)
            qm_max = 8 if self.scheduler.mcs_table == "qam256" else 6
            dl_ratio = 1.0 if self.fdd else self.tdd.dl_ratio()
            ul_ratio = 1.0 if self.fdd else 1.0 - self.tdd.dl_ratio()
            comm = self.metrics.finalize(
                peak_se_dl=peak_spectral_efficiency(
                    min(4, self.n_ue_ants, self.n_tx), qm_max, dl_ratio
                ),
                peak_se_ul=peak_spectral_efficiency(
                    min(4, self.n_ue_ants, self.n_tx), qm_max, ul_ratio
                ),
            )
            if self.pcap is not None:
                self.pcap.save()
            out = {"communication": comm, "sensing": None, "cell": self.cell.name}
            if (
                self.cell.log.enable_traces
                or self.cell.log.cqi_visualization
                or self.cell.log.rb_visualization
            ):
                out["logs"] = self.sched_log.finalize()
        if self.enable_sensing and sensing:
            out["sensing"] = self.run_sensing()
        return out

    # ------------------------------------------------------------------- run

    def run(self, start_slot: int = 0, stop_slot: int | None = None,
            finalize: bool = True):
        """Main slot loop (cellSimulation.m:147-187) + sensing post-pass.
        start_slot/stop_slot bound the loop for checkpoint/resume. With
        block_slots >= 1 (and the full PHY) the slots run in block mode."""
        stop = self.num_slots if stop_slot is None else stop_slot
        if self.block_slots >= 1 and not self.passthrough:
            self._run_blocks(start_slot, stop)
        else:
            for slot in range(start_slot, stop):
                with tracing.span("cell.slot", slot=slot):
                    info = self._slot_begin(slot)
                    n_dl = self._dl_syms(info)
                    if n_dl:
                        st = self._dl_tx_phase(slot, n_dl, csi_slot=info["csi_slot"])
                        if st is not None:
                            self._dl_rx_phase(slot, info["csi_slot"], st)
                    self._slot_finish(slot, info)
        if finalize:
            return self.finalize()
        return None

    # ------------------------------------------------------------ block mode

    def _has_deferred_due(self, slot: int) -> bool:
        return any(e["due"] <= slot for e in self._deferred) or any(
            p.due_slot <= slot for p in self.pending
        )

    def _plan_slot(self, slot: int, info: dict) -> dict:
        """Host control plane of one slot in block mode, in the slot loop's
        order (DL plan -> UL plan -> BSR -> SRS plan), with no device work."""
        n_dl = self._dl_syms(info)
        n_ul = self._ul_syms(info)
        p = {"slot": slot, "n_dl": n_dl, "n_ul": n_ul,
             "csi": info["csi_slot"], "dl": None, "ul": None, "srs": None}
        if n_dl:
            p["dl"] = self._plan_dl(slot, n_dl, info["csi_slot"])
        if n_ul:
            p["ul"] = self._plan_ul(slot, n_ul)
        self._epilogue_bsr(slot, info)
        if info["sounding"]:
            p["srs"] = self._plan_srs(info["sounding"])
        return p

    def _plan_min_due(self, p: dict) -> int:
        """Earliest due slot of the plan's device results: the segment ends
        before it, where the slot loop would read them back."""
        s = p["slot"]
        dues = []
        if p["dl"] is not None and (p["dl"]["groups"] or p["csi"]):
            dues.append(self._next_ul_slot(s))
        if p["ul"] is not None or p["srs"] is not None:
            dues.append(s + 1)
        return min(dues) if dues else 10**9

    def _run_blocks(self, start: int, stop: int):
        """Block-mode slot loop: the host plans slots ahead until the next
        feedback-due boundary (or block_slots slots), then the segment's
        device work is dispatched (sim/block.py). Due slots, keys and every
        result equal the slot loop's."""
        slot = start
        while slot < stop:
            plans: list = []
            horizon = 10**9
            while slot < stop and len(plans) < self.block_slots:
                if plans and (horizon <= slot or self._has_deferred_due(slot)):
                    break
                info = self._slot_begin(slot)
                p = self._plan_slot(slot, info)
                plans.append(p)
                horizon = min(horizon, self._plan_min_due(p))
                slot += 1
            dispatch_segment(self, plans)

    # --------------------------------------------------------- checkpointing

    _CKPT_FIELDS = (
        "scheduler", "rlc_gnb", "rlc_ue", "lcp_dl", "lcp_ul",
        "traffic_dl", "traffic_ul", "pending", "_deferred", "rx_soft_bufs",
        "srs_due", "metrics", "sched_log",
    )

    def checkpoint(self, next_slot: int) -> dict:
        """Host-serializable snapshot of all carried simulation state at a slot
        boundary. Device tensors (deferred CRC/CSI results, HARQ soft buffers,
        accumulated sensing grids) become numpy copies; their protocol due
        slots are part of the snapshot and fire the same after restore. The
        result pickles."""
        memo: dict = {}

        def to_host(obj):
            oid = id(obj)
            if oid in memo:
                return memo[oid]
            if isinstance(obj, torch.Tensor):
                out = obj.detach().cpu().numpy()
            elif isinstance(obj, dict):
                out = {}
                memo[oid] = out
                out.update({k: to_host(v) for k, v in obj.items()})
                return out
            elif isinstance(obj, (list, tuple)):
                out = type(obj)(to_host(v) for v in obj)
            else:
                out = obj
            memo[oid] = out
            return out

        state = {"next_slot": next_slot, "seed": self._seed, "cell_name": self.cell.name}
        for f in self._CKPT_FIELDS:
            state[f] = to_host(getattr(self, f))
        state["_sen_slots"] = to_host(self._sen_slots) if self.enable_sensing else None
        # round-trip through pickle so callers can also persist the blob
        return pickle.loads(pickle.dumps(copy.deepcopy(state)))

    def restore(self, state: dict):
        """Load a checkpoint() snapshot into a freshly constructed simulator of
        the same configuration; continue with run(start_slot=state['next_slot']).
        The numpy soft buffers, deferred results and sensing grids go back to
        the device where they are used."""
        if state["cell_name"] != self.cell.name or state["seed"] != self._seed:
            raise ValueError("checkpoint belongs to a different cell/seed")
        for f in self._CKPT_FIELDS:
            setattr(self, f, state[f])
        if self.enable_sensing and state["_sen_slots"] is not None:
            self._sen_slots = state["_sen_slots"]
        return state["next_slot"]
