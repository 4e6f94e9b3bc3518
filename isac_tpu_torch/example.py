"""Example inputs of the port's headline paths.

`example_sensing`: the mono-static sensing chain at the reference benchmark's
inputs (default gNB, one target, a QPSK-filled DL grid on every slot).

`example_link_batch`: the batched PDSCH link step (numpy counterpart of the
reference's ``__graft_entry__._example_link_batch``): 16-port gNB (8 cross-polarized
pairs at half-wavelength) to 2-antenna UEs over alternating CDL-D / CDL-A
links at 3.5 GHz, SCS 30 kHz, random Type-1 PRG precoders and unit-variance
noise, all drawn from one numpy seed so that the reference and the port see
the same numbers.

`example_link_loop`: one closed link-adaptation loop per direction through
the public per-grant functions (CSI-RS / SRS measurement, RI/PMI/CQI/TPMI
selection, batched PDSCH / PUSCH with HARQ retransmissions); see LinkLoop.

`example_cell`: the per-cell system-level engine (sim/cell.py CellSimulator)
on the reference's shipped scenario, open_street_map_city (every link LoS).

`example_network`: co-channel cells of multi_cell in lockstep (sim/network.py
SyncNetworkRunner) with DL + UL interference and the city's line of sight.
"""

from __future__ import annotations

import numpy as np
import torch

from dataclasses import replace

from isac_tpu_torch.config.params import ULA, GNBParams, SimulationParameters, assign_cell_parameters
from isac_tpu_torch.config.scenarios import multi_cell, open_street_map_city
from isac_tpu_torch.mac.tables import cqi_to_mcs
from isac_tpu_torch.ops.cdl import build_cdl_link, subcarrier_freqs
from isac_tpu_torch.ops.csi import (
    SINR_TO_CQI_UL,
    cqi_select,
    ri_select,
    subband_size,
    ul_tpmi_select,
)
from isac_tpu_torch.ops.csirs import csirs_estimate_fdm, csirs_fdm_reserved, csirs_fill_fdm
from isac_tpu_torch.ops.precoding import (
    csirs_panel_dims,
    panel_config_for_antenna,
    pusch_codebook,
    type1_codebook,
    type1_multipanel_codebook,
)
from isac_tpu_torch.ops.srs import srs_estimate_ports, srs_fill_grid
from isac_tpu_torch.ops.transport import RV_SEQUENCE
from isac_tpu_torch.parallel.links import batched_frequency_response, stack_links
from isac_tpu_torch.phy.chains import (
    SCHGrant,
    grant_tbs,
    sch_receive_batch,
    sch_transmit_batch,
)
from isac_tpu_torch.sim.cell import CellSimulator
from isac_tpu_torch.sim.network import SyncNetworkRunner, resolve_los_cross
from isac_tpu_torch.sim.sensing import make_sensing_chain
from isac_tpu_torch.utils.device import resolve_device

N_TX, N_RX = 16, 2


def example_links(n_links: int, seed: int = 0, n_tx: int = N_TX, n_rx: int = N_RX):
    """The example's per-link CDL constants (numpy CDLLinks): n_tx gNB ports
    as n_tx/2 cross-polarized pairs, n_rx UE antennas."""
    lam = 3e8 / 3.5e9
    etx = np.stack([np.zeros(n_tx), np.repeat(np.arange(n_tx // 2), 2) * 0.5 * lam,
                    np.zeros(n_tx)], -1)
    erx = np.stack([np.zeros(n_rx), np.arange(n_rx) * 0.5 * lam, np.zeros(n_rx)], -1)
    return [
        build_cdl_link("CDL-D" if i % 2 == 0 else "CDL-A", 300.0, 3.5e9, etx, erx,
                       ue_velocity=0.43, seed=seed + i)
        for i in range(n_links)
    ]


def example_link_batch(n_prb=51, n_links=4, mcs=19, n_layers=2, seed=0, device=None):
    """(grant, (tb, w, h, noise), tbs) with the tensors on `device`
    (None = the card)."""
    dev = resolve_device(device)
    n_sc = n_prb * 12
    bl = stack_links(example_links(n_links, seed), device=dev)
    t = np.arange(14) * (5e-4 / 14)
    h = batched_frequency_response(bl, t, subcarrier_freqs(n_sc, 30e3), scale=1579.0)
    g = SCHGrant(n_prb=n_prb, n_layers=n_layers, mcs=mcs, n_sc_grid=n_sc)
    tbs = grant_tbs(g)
    rng = np.random.default_rng(seed)
    tb = torch.as_tensor(rng.integers(0, 2, (n_links, tbs)).astype(np.int8), device=dev)
    n1, n2 = csirs_panel_dims(N_TX)
    cb = type1_codebook(n1, n2, n_layers)
    n_prg = (n_prb + 1) // 2
    w = torch.as_tensor(
        np.stack([cb[rng.integers(0, cb.shape[0], n_prg)] for _ in range(n_links)]),
        device=dev,
    )  # [L, n_prg, ports, layers]
    noise = torch.as_tensor(
        ((rng.standard_normal((n_links, N_RX, 14, n_sc))
          + 1j * rng.standard_normal((n_links, N_RX, 14, n_sc))) * np.sqrt(0.5)
         ).astype(np.complex64),
        device=dev,
    )
    return g, (tb, w, h, noise), tbs


# ------------------------------------------------------------------ link loop
#
# Host-side decisions of the loop, plain numpy: what the per-slot engine's
# scheduler does with a report, cut down to what one loop needs.


def loop_mcs(cqi_sb: np.ndarray, sb_of_prb: np.ndarray, prbs) -> int:
    """MCS of a grant from the per-subband CQI of a report: the CQI of each
    allocated PRB, averaged and floored, through cqi_to_mcs."""
    cqi_rb = np.asarray(cqi_sb)[sb_of_prb][np.asarray(prbs)]
    return cqi_to_mcs(int(np.floor(cqi_rb.mean())))


def loop_dl_precoder(cb: np.ndarray, pmi_sb: np.ndarray, prbs, sb_size: int) -> np.ndarray:
    """Per-canonical-PRG precoders [n_prg, P, L] from the subband PMI: PRGs
    pair the allocated PRBs in sorted order, and each uses the PMI of the
    subband its first PRB falls in."""
    pmi_sb = np.asarray(pmi_sb, np.int64) % cb.shape[0]
    first_prb = np.asarray(prbs, np.int64)[0::2]
    prg_to_sb = np.minimum(first_prb // sb_size, len(pmi_sb) - 1)
    return cb[pmi_sb[prg_to_sb]]


def loop_ul_cqi(sinr_db_sb: np.ndarray) -> np.ndarray:
    """Per-subband UL CQI from the SRS report's SINR (host threshold map)."""
    return np.sum(np.asarray(sinr_db_sb)[..., None] >= SINR_TO_CQI_UL[None, :],
                  axis=-1).astype(np.int64)


def loop_noise(rng: np.random.Generator, shape: tuple, sigma2: float) -> np.ndarray:
    """Complex AWGN of variance sigma2, complex64 (one draw order for both
    packages: real part first, then imaginary)."""
    re = rng.standard_normal(shape)
    im = rng.standard_normal(shape)
    return ((re + 1j * im) * np.sqrt(sigma2 / 2)).astype(np.complex64)


def loop_group(grants: list) -> dict:
    """Indices of grants by layout_key(), in first-seen order."""
    groups: dict = {}
    for i, g in enumerate(grants):
        groups.setdefault(g.layout_key(), []).append(i)
    return groups


class LinkLoop:
    """One cell's closed link-adaptation loop, both directions, through the
    public per-grant functions. n_ues UEs are frequency-multiplexed on
    n_prb // n_ues contiguous PRBs each; the gNB has n_tx ports (n_tx/2
    cross-polarized pairs), every UE n_ue_ants antennas; UE u rides the CDL
    link u of example_links (UL channel = the DL channel transposed).

    DL: csi_report() sends the n_tx-port FDM CSI-RS, estimates each UE's
    channel from it and selects RI, subband PMI and CQI; dl_slot() sends one
    PDSCH grant per UE (rate-matched around the CSI-RS, which rides the same
    grid), receives them in one batch per layout group and keeps each UE's
    HARQ state: a failed TB is sent again with the next RV_SEQUENCE entry and
    its soft buffers, together with the other UEs' new TBs.
    UL: srs_report() sounds all UEs on symbol 13 (comb 4, offset u % 4),
    estimates each at the gNB and selects RI and TPMI; ul_slot() sends one
    PUSCH grant per UE through its own channel, sums at the gNB and receives
    the batch (n_rx = n_tx).

    The noise levels put the PDSCH noise (sigma2_dl) 7.8 dB above the noise the
    CSI report was measured at (sigma2_csi), as after a rise of interference
    between report and grant: the reported MCS is then too high for some UEs,
    whose first transmission fails and whose retransmission combines.

    All random inputs come from the numpy Generator given to each call, so the
    same seed gives the same loop on any device. A caller that times the loop
    draws each call's AWGN beforehand with draw_noise() and passes it as
    `noise`; the call then adds that tensor where it would add its own draw."""

    n_id, slot = 1, 0  # cell identity and slot number of every grant and CSI-RS
    sigma2_csi, sigma2_dl, sigma2_ul = 0.002, 0.012, 0.002  # noise variances

    def __init__(self, n_prb=273, n_ues=4, n_tx=16, n_ue_ants=2, seed=0, device=None):
        self.dev = resolve_device(device)
        self.n_prb, self.n_ues, self.n_tx, self.n_ue_ants = n_prb, n_ues, n_tx, n_ue_ants
        self.n_sc = 12 * n_prb
        self.links = example_links(n_ues, seed, n_tx, n_ue_ants)
        bl = stack_links(self.links, device=self.dev)
        t = np.arange(14) * (5e-4 / 14)
        self.h_dl = batched_frequency_response(bl, t, subcarrier_freqs(self.n_sc, 30e3))
        self.h_ul = self.h_dl.transpose(-1, -2)  # [U, S, K, gNB, UE]
        self.ng, self.n1, self.n2 = panel_config_for_antenna(
            ULA(n_v=n_tx // 2, polarizations=2))
        self.max_rank = min(4, n_ue_ants, n_tx)
        self.sb_size = subband_size(n_prb)
        self.sb_of_prb = (np.arange(n_prb) // self.sb_size).astype(np.int64)
        per = n_prb // n_ues
        self.ue_prbs = [tuple(range(u * per, (u + 1) * per)) for u in range(n_ues)]
        self.reserved = csirs_fdm_reserved(n_tx)
        self.csirs_np = csirs_fill_fdm(self.slot, self.n_id, n_prb, n_tx, self.n_sc)
        self.csirs = torch.as_tensor(self.csirs_np, device=self.dev)
        srs = []
        for u in range(n_ues):
            g = np.zeros((n_ue_ants, 14, self.n_sc), np.complex64)
            srs.append(srs_fill_grid(g, n_prb, symbol=13, comb=4, comb_offset=u % 4)[0])
        self.srs_np = np.stack(srs)
        self.srs = torch.as_tensor(self.srs_np, device=self.dev)
        self.dl_csi = None  # per UE: dict(rank, pmi_sb, cqi_sb)
        self.ul_csi = None  # per UE: dict(rank, tpmi, cqi_sb)
        self.harq = {"DL": [None] * n_ues, "UL": [None] * n_ues}
        self.rx_calls = 0  # sch_receive_batch calls made so far

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.dev)

    def draw_noise(self, rng: np.random.Generator, call: str) -> torch.Tensor:
        """The AWGN of one call ('csi_report', 'dl_slot': per UE antenna;
        'srs_report', 'ul_slot': per gNB antenna), on the loop's device."""
        sigma2 = {"csi_report": self.sigma2_csi, "dl_slot": self.sigma2_dl,
                  "srs_report": self.sigma2_ul, "ul_slot": self.sigma2_ul}[call]
        at_ue = call in ("csi_report", "dl_slot")
        shape = (self.n_ues, self.n_ue_ants) if at_ue else (self.n_tx,)
        return self._t(loop_noise(rng, (*shape, 14, self.n_sc), sigma2))

    # ------------------------------------------------------------------ reports

    def csi_report(self, rng: np.random.Generator, noise=None) -> list:
        """CSI-RS -> per-UE estimate -> RI + per-rank CQI/PMI reports; the
        chosen rank's report is kept per UE and returned."""
        if noise is None:
            noise = self.draw_noise(rng, "csi_report")
        rx_all = torch.einsum("tsk,uskat->uask", self.csirs, self.h_dl) + noise
        dev_reports = []
        for u in range(self.n_ues):
            h = csirs_estimate_fdm(rx_all, self.slot, self.n_id, self.n_prb, self.n_tx,
                                   ue_index=u)
            rank = ri_select(h, self.sigma2_csi, max_rank=self.max_rank)
            reps = [cqi_select(h, self.sigma2_csi, r, self.n1, self.n2,
                               subband_of_re=self.sb_of_prb, ng=self.ng)
                    for r in range(1, self.max_rank + 1)]
            dev_reports.append((rank, reps, h))
        out = []
        for rank, reps, h in dev_reports:
            r = int(rank)
            rep = reps[r - 1]
            out.append({"rank": r, "pmi_sb": rep["pmi_sb"].cpu().numpy(),
                        "cqi_sb": rep["cqi_sb"].cpu().numpy(),
                        "sinr_db_sb": rep["sinr_db_sb"].cpu().numpy(), "h_est": h})
        self.dl_csi = out
        return out

    def srs_report(self, rng: np.random.Generator, noise=None) -> list:
        """SRS of all UEs summed at the gNB -> per-UE estimate -> RI + per-rank
        TPMI candidates; the chosen rank's is kept per UE and returned."""
        if noise is None:
            noise = self.draw_noise(rng, "srs_report")
        rx = torch.einsum("utsk,uskat->ask", self.srs, self.h_ul) + noise
        dev_reports = []
        for u in range(self.n_ues):
            h, _ = srs_estimate_ports(rx, self.n_prb, self.n_ue_ants, symbol=13, comb=4,
                                      comb_offset=u % 4, per_prb=True)
            rank = ri_select(h, self.sigma2_ul, max_rank=self.max_rank)
            cands = [ul_tpmi_select(h, self.sigma2_ul, r, subband_of_re=self.sb_of_prb)
                     for r in range(1, self.max_rank + 1)]
            dev_reports.append((rank, cands, h))
        out = []
        for rank, cands, h in dev_reports:
            r = int(rank)
            tpmi, sinr_db_sb = cands[r - 1]
            sdb = sinr_db_sb.cpu().numpy()
            out.append({"rank": r, "tpmi": int(tpmi), "sinr_db_sb": sdb,
                        "cqi_sb": loop_ul_cqi(sdb), "h_est": h})
        self.ul_csi = out
        return out

    # -------------------------------------------------------------------- slots

    def _grants(self, direction: str, rng: np.random.Generator):
        """This slot's grant, TB and precoder per UE: a UE whose last TB failed
        sends it again with the next RV and keeps MCS and rank; the others
        draw a new TB at the MCS and rank of their current report."""
        csi = self.dl_csi if direction == "DL" else self.ul_csi
        grants, tbs, ws, bufs = [], [], [], []
        for u in range(self.n_ues):
            st = self.harq[direction][u]
            if st is None:
                rep = csi[u]
                mcs = loop_mcs(rep["cqi_sb"], self.sb_of_prb, self.ue_prbs[u])
                st = {"mcs": mcs, "rank": rep["rank"], "tx": 0, "bufs": None, "tb": None,
                      "w": self._precoder(direction, rep, u)}
            g = SCHGrant(
                rnti=u + 1, n_id=self.n_id, slot=self.slot, prb_start=self.ue_prbs[u][0],
                n_prb=len(self.ue_prbs[u]), mcs=st["mcs"], n_layers=st["rank"],
                rv=RV_SEQUENCE[st["tx"]], n_sc_grid=self.n_sc, direction=direction,
                reserved_per_prb=self.reserved if direction == "DL" else (),
            )
            if st["tb"] is None:
                st["tb"] = rng.integers(0, 2, grant_tbs(g)).astype(np.int8)
            self.harq[direction][u] = st
            grants.append(g)
            tbs.append(st["tb"])
            ws.append(st["w"])
            bufs.append(st["bufs"])
        return grants, tbs, ws, bufs

    def _precoder(self, direction: str, rep: dict, u: int) -> np.ndarray:
        if direction == "UL":
            return pusch_codebook(self.n_ue_ants, rep["rank"])[rep["tpmi"]]
        if self.ng > 1:
            cb = type1_multipanel_codebook(self.ng, self.n1, self.n2, rep["rank"])
        else:
            cb = type1_codebook(self.n1, self.n2, rep["rank"])
        return loop_dl_precoder(cb, rep["pmi_sb"], self.ue_prbs[u], self.sb_size)

    def _finish(self, direction: str, grants, tbs, outs_by_group, groups) -> list:
        """Read the CRC flags back, update the HARQ state, return one record
        per UE: dict(ue, rv, mcs, rank, crc_ok, tb_equal, sinr_db, dropped)."""
        recs = [None] * self.n_ues
        for key, idx in groups.items():
            out = outs_by_group[key]
            ok = out["crc_ok"].cpu().numpy()
            tb = out["tb"].cpu().numpy()
            sinr = out["sinr_db"].cpu().numpy()
            for j, u in enumerate(idx):
                st = self.harq[direction][u]
                recs[u] = {"ue": u, "rv": grants[u].rv, "mcs": st["mcs"], "rank": st["rank"],
                           "crc_ok": bool(ok[j]), "tb": tb[j],
                           "tb_equal": bool(np.array_equal(tb[j], tbs[u])),
                           "sinr_db": float(sinr[j]), "dropped": False}
                if ok[j]:
                    self.harq[direction][u] = None
                elif st["tx"] + 1 >= len(RV_SEQUENCE):
                    recs[u]["dropped"] = True
                    self.harq[direction][u] = None
                else:
                    st["tx"] += 1
                    st["bufs"] = out["soft_buffers"][j]
        return recs

    def dl_slot(self, rng: np.random.Generator, noise=None) -> list:
        """One DL slot: PDSCH of every UE + CSI-RS on one port grid -> per-UE
        channel and noise -> batched receive. Returns one record per UE."""
        grants, tbs, ws, bufs = self._grants("DL", rng)
        if noise is None:
            noise = self.draw_noise(rng, "dl_slot")
        groups = loop_group(grants)
        port_grid = self.csirs
        for idx in groups.values():
            port_grid = port_grid + sch_transmit_batch(
                [tbs[i] for i in idx], [grants[i] for i in idx], [ws[i] for i in idx],
                reduce_sum=True, device=self.dev)
        rx_all = torch.einsum("tsk,uskat->uask", port_grid, self.h_dl) + noise
        outs = {}
        for key, idx in groups.items():
            outs[key] = sch_receive_batch(
                rx_all, [grants[i] for i in idx], [bufs[i] for i in idx],
                rx_indices=np.asarray(idx))
            self.rx_calls += 1
        return self._finish("DL", grants, tbs, outs, groups)

    def ul_slot(self, rng: np.random.Generator, noise=None) -> list:
        """One UL slot: PUSCH of every UE through its own channel, summed at the
        gNB with noise -> batched receive. Returns one record per UE."""
        grants, tbs, ws, bufs = self._grants("UL", rng)
        groups = loop_group(grants)
        rx = self.draw_noise(rng, "ul_slot") if noise is None else noise
        for idx in groups.values():
            grids = sch_transmit_batch(
                [tbs[i] for i in idx], [grants[i] for i in idx], [ws[i] for i in idx],
                reduce_sum=False, device=self.dev)  # [n, UE ants, 14, K]
            h = self.h_ul[self._t(np.asarray(idx, np.int64))]
            rx = rx + torch.einsum("utsk,uskat->ask", grids, h)
        outs = {}
        for key, idx in groups.items():
            outs[key] = sch_receive_batch(
                [rx] * len(idx), [grants[i] for i in idx], [bufs[i] for i in idx])
            self.rx_calls += 1
        return self._finish("UL", grants, tbs, outs, groups)


def example_link_loop(n_prb=273, n_ues=4, n_tx=16, n_ue_ants=2, seed=0, device=None):
    """The link loop at the benches' carrier width (273 PRB = 100 MHz at SCS
    30 kHz, 16 gNB ports, 2-antenna UEs, 4 UEs on 68 PRBs each) or, for tests,
    at a few PRBs. Returns a LinkLoop on `device` (None = the card)."""
    return LinkLoop(n_prb, n_ues, n_tx, n_ue_ants, seed, device)


def example_sensing(num_slots=20, seed=0, device=None, gnb=None,
                    targets=(((120.0, 40.0, 1.5),), (1.0,), (7.0,))):
    """(chain, params, grids) of the sensing chain at the reference benchmark's
    inputs: the default gNB (3.5 GHz, 100 MHz at SCS 30 kHz = 273 PRB, 8x2-pol
    ULA, 44 dBm), one target at (120, 40, 1.5) m with RCS 1 m^2 and 7 m/s, and a
    +-1 +-1j QPSK grid on all `num_slots` slots from one numpy seed, scaled by the
    reference amplitude law 10^((P_dBm-30)/20) * sqrt(nfft^2 / (n_sc * n_tx)).

    targets is (positions [T, 3], rcs [T], radial velocities [T]); gnb overrides
    the default GNBParams (a narrower carrier for tests). `chain(grids, gen)`
    runs the 2D-FFT chain with MUSIC DoA (sim/sensing.py:make_sensing_chain);
    the grid is one tensor on `device` (None = the card) spanning all slots."""
    dev = resolve_device(device)
    if gnb is None:
        gnb = GNBParams(antenna=ULA(n_v=8, polarizations=2))
    carrier = gnb.carrier
    info, n_sc, n_tx = carrier.ofdm, carrier.n_sc, gnb.num_tx_ants
    n_sym = num_slots * info.symbols_per_slot
    rng = np.random.default_rng(seed)
    grid = (
        (rng.integers(0, 2, (n_tx, n_sym, n_sc)) * 2 - 1)
        + 1j * (rng.integers(0, 2, (n_tx, n_sym, n_sc)) * 2 - 1)
    ).astype(np.complex64) / np.sqrt(2)
    amp = float(10 ** ((gnb.tx_power_dbm - 30) / 20) * np.sqrt(info.nfft**2 / (n_sc * n_tx)))
    pos, rcs, vel = targets
    chain, params = make_sensing_chain(
        gnb, carrier, pos, rcs, vel, num_slots, starts=(0,), widths=(n_sym,), device=dev,
    )
    grid_dev = torch.as_tensor(grid.astype(np.complex64), device=dev) * amp
    return chain, params, (grid_dev,)


def example_cell(n_rb=None, nfft=None, traces=False, device=None, **engine_kwargs):
    """The engine on the reference's shipped scenario (config/scenarios.py
    open_street_map_city): 273 PRB at SCS 30 kHz (100 MHz, nfft 4096), a
    16-port gNB (8x2-pol ULA, 44 dBm), 5 two-antenna UEs, one target, PF
    scheduling, On-Off traffic at 40 / 10 Mbps, CDL-D, UMa pathloss, DDDSU,
    one frame of 20 slots, sensing with MUSIC DoA. n_rb / nfft cut the carrier
    (tests run 24 PRB / 512 on the CPU); traces=True records the per-slot
    trace; engine_kwargs go to CellSimulator (block_slots=, mesh=, ...).
    Returns a CellSimulator of seed 0 on `device` (None = the card); `.run()`
    simulates the frame and returns the KPIs, logs and sensing result."""
    cell = assign_cell_parameters(open_street_map_city(SimulationParameters()))[0]
    if traces:
        cell = replace(cell, log=replace(cell.log, enable_traces=True))
    return CellSimulator(cell, n_rb_override=n_rb, nfft_override=nfft, device=device,
                         **engine_kwargs)


def example_network(num_cells=2, n_rb=None, nfft=None, traces=False, sensing=True, device=None,
                    mesh=None):
    """The lockstep network on multi_cell (config/scenarios.py): num_cells
    co-channel copies of the shipped cell on a 500 m hex grid, each at 273 PRB
    (n_rb / nfft cut the carrier), 16 gNB ports, 5 UEs and one target, the
    line of sight of every serving and cross link from the synthetic city
    (resolve_los_cross), DL + UL interference. traces=True records each
    cell's per-slot trace; sensing=False leaves the post-pass out; mesh (a
    DeviceMesh with a `cell` dimension) shards the DL cross terms. Returns a
    SyncNetworkRunner of seed 0 on `device` (None = the card); `.run()`
    simulates one frame and returns each cell's result."""
    sim = multi_cell(SimulationParameters(), num_cells=num_cells)
    sim.validate()
    cells, cross_los = resolve_los_cross(assign_cell_parameters(sim), sim)
    if traces:
        cells = [replace(c, log=replace(c.log, enable_traces=True)) for c in cells]
    return SyncNetworkRunner(cells, seed=0, cross_los=cross_los, n_rb_override=n_rb,
                             nfft_override=nfft, enable_sensing=sensing, device=device,
                             mesh=mesh)
