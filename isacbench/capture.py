"""Read-only taps on the program's timed path.

The taps wrap a few functions and methods of isac_tpu_torch for the length
of a run, call the original unchanged, and keep device copies of a small
sample of what went in and came out: the stage boundaries that the plain
reference (``reference/``) recomputes once the window has closed. Which
events are kept is drawn from the run's seed: for each kind, the ordinals
listed by the traffic's ``check`` plan (one within the first ``first``
events, so every run compares something, the rest within ``within``). What
is kept is copied to the host without waiting for the card (``keep``), so it
adds nothing to the device's peak memory and nothing is synchronised inside
the window. The taps also list each decoder launch's shape for the kernel's
roofline.

Taps (every name here is the program's; a change to one of them that the
taps do not follow reads as a number with nothing to compare, infinite):

- ``CellSimulator._dl_rx_phase`` / ``_ul_rx_phase`` with ``_noise`` and the
  engine's ``sch_receive_batch``: the slot's transmitted grants (transport
  block, grant, precoder) and whole port grids, and at sampled subcarriers
  the channel response, the noise and the received grid;
- ``SyncNetworkRunner._dl_ext`` / ``_ul_ext``: every source cell's grids and
  the destination's bank response, at the same subcarriers;
- ``SyncNetworkRunner._build_banks`` with ``build_cdl_link``: the ray
  constants of each bank's links, in build order;
- the engine's ``sch_receive_batch`` again, for a sampled receive call, with
  the PHY chains' ``estimate_channel_canonical``, ``mmse_equalize``,
  ``demodulate_llr`` and ``descramble_llr`` and the transport's
  ``sch_decode``: every stage boundary of that call, from the received
  allocation to the transport blocks and CRC flags;
- ``ldpc_layered.layered_posterior``: decoder input LLRs and posteriors;
- ``CellSimulator._prepare_tx`` / ``_consume_due``: transmitted transport
  blocks and what the receiver delivered for them, with its CRC flag;
- ``CellSimulator.run_sensing`` with ``sim.sensing.fft_2d_estimate``: the
  echo grid and transmit grid of every antenna, the range-Doppler map's rows
  that the detection zone reaches, and the post-pass's detections and
  azimuths.
"""

from __future__ import annotations

import numpy as np
import torch


def keep(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`, enqueued without waiting for the card: valid once
    the card has been synchronised."""
    if t.is_cuda:
        return t.detach().to("cpu", non_blocking=True)
    return t.detach().clone()


def grant_fields(sg) -> dict:
    """What the reference reads of a grant (phy.chains.SCHGrant)."""
    return {"rnti": sg.rnti, "n_id": sg.n_id, "slot": sg.slot, "prbs": tuple(sg.prbs),
            "qm": sg.qm, "rate": sg.code_rate, "mcs": sg.mcs, "n_layers": sg.n_layers,
            "rv": sg.rv, "add_pos": sg.dmrs_add_pos, "sym_start": sg.sym_start,
            "n_sym": sg.n_sym, "reserved": tuple(sg.reserved_per_prb),
            "n_sc_grid": sg.n_sc_grid}


class Capture:
    def __init__(self, seed: int, plan: dict):
        self.rng = np.random.default_rng([seed % 2**64, 0x15AC])
        self.n_k = int(plan.get("subcarriers", 48))
        self.pick = {}
        for kind, p in plan.items():
            if kind == "subcarriers":
                continue
            first, within, n = int(p["first"]), int(p["within"]), int(p["n"])
            chosen = {int(self.rng.integers(first))}
            rest = self.rng.choice(within, size=min(n, within), replace=False)
            chosen.update(int(x) for x in rest[: max(n - 1, 0)])
            self.pick[kind] = chosen
        self.count: dict = {}
        self.enabled = False
        self.recs = {"dl": [], "ul": [], "ldpc": [], "tb": [], "rdm": [], "rxc": []}
        self.chain = None
        self.pending: dict = {}
        self.current = None
        self.net_ids: set = set()
        self.bank_links: list | None = None
        self.cross_los: dict = {}
        self.launches: list = []
        self._collect = None
        self._tx_tb: dict = {}
        self.sensing_sim = None
        self._patches: list = []

    def take(self, kind: str) -> bool:
        if not self.enabled or kind not in self.pick:
            return False
        i = self.count.get(kind, 0)
        self.count[kind] = i + 1
        return i in self.pick[kind]

    def _ks(self, n_sc: int) -> np.ndarray:
        return np.sort(self.rng.choice(n_sc, size=min(self.n_k, n_sc), replace=False))

    # ----------------------------------------------------------- records

    def _rx_rec(self, direction: str, sim, slot: int, st: dict) -> dict:
        ks = self._ks(sim.n_sc)
        kt = torch.as_tensor(ks, device=sim.dev)
        rec = {"slot": slot, "ks": ks, "kt": kt, "sim_id": id(sim),
               "cell": sim.cell, "nfft": sim.info.nfft, "n_sc": sim.n_sc}
        if direction == "DL":
            grid = st["port_grid"]
            items = [it for group in st["groups"].values() for it in group]
            rec["links"] = sim.links_dl
        else:
            grid = torch.stack(st["all_grids"])
            items = st["all_items"]
            rec["grants"] = [(g.ue, len(g.prb_set)) for g, _, _, _ in items]
            rec["links"] = sim.links_ul
        rec["x"] = keep(grid.index_select(-1, kt))
        rec["x_full"] = keep(grid)
        rec["tx"] = [(grant_fields(sg), np.array(tb, np.uint8, copy=True),
                      np.array(w, np.complex64, copy=True)) for _, sg, tb, w in items]
        return rec

    def _rx_phase(self, direction: str, orig, sim, slot, *args, st, ext):
        key = (direction, id(sim))
        rec = self.pending.pop(key, None)
        if rec is None and id(sim) not in self.net_ids and self.take(direction.lower() + "_rx"):
            rec = self._rx_rec(direction, sim, slot, st)
        if rec is None:
            return orig(sim, slot, *args, st, ext=ext)
        if direction == "DL" and args[0] and not sim.fast_csi:
            rec["csi_res"] = tuple(sim.csirs_reserved)  # the CSI-RS rides this slot's grid
        self.current = rec
        try:
            out = orig(sim, slot, *args, st, ext=ext)
        finally:
            self.current = None
        h = sim._h_slot(slot, direction)
        rec["h"] = keep(h.index_select(2, rec["kt"]))
        if "y" in rec and "n" in rec:
            self.recs[direction.lower()].append(rec)
        return out

    # ----------------------------------------------------------- install

    def _patch(self, owner, name, fn):
        self._patches.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def install(self):
        import isac_tpu_torch.ops.ldpc_layered as ldpc_layered
        import isac_tpu_torch.ops.transport as transport
        import isac_tpu_torch.phy.chains as chains
        import isac_tpu_torch.sim.cell as cell_mod
        import isac_tpu_torch.sim.network as net_mod
        import isac_tpu_torch.sim.sensing as sen_mod

        cap = self
        CS, NR = cell_mod.CellSimulator, net_mod.SyncNetworkRunner
        o = {name: getattr(CS, name) for name in
             ("_dl_rx_phase", "_ul_rx_phase", "_noise", "_prepare_tx", "_consume_due",
              "run_sensing")}
        o.update({name: getattr(NR, name) for name in ("_dl_ext", "_ul_ext", "_build_banks")})
        o_rx = cell_mod.sch_receive_batch
        o_link = net_mod.build_cdl_link
        o_post = ldpc_layered.layered_posterior
        o_fft2d = sen_mod.fft_2d_estimate

        def dl_rx_phase(sim, slot, csi_slot, st, ext=None):
            return cap._rx_phase("DL", o["_dl_rx_phase"], sim, slot, csi_slot, st=st, ext=ext)

        def ul_rx_phase(sim, slot, st, ext=None):
            return cap._rx_phase("UL", o["_ul_rx_phase"], sim, slot, st=st, ext=ext)

        def noise(sim, shape, key):
            n = o["_noise"](sim, shape, key)
            rec = cap.current
            if rec is not None and rec["sim_id"] == id(sim) and "n" not in rec:
                rec["n"] = keep(n.index_select(-1, rec["kt"]))
            return n

        def receive(rx, grants, *args, **kwargs):
            rec = cap.current
            if rec is not None and "y" not in rec and "n" in rec:
                rec["y"] = keep(rx.index_select(-1, rec["kt"]))
            if cap.chain is not None or not cap.take("rxc"):
                return o_rx(rx, grants, *args, **kwargs)
            cap.chain = {"grants": [grant_fields(g) for g in grants]}
            try:
                out = o_rx(rx, grants, *args, **kwargs)
            finally:
                chain, cap.chain = cap.chain, None
            chain["out"] = {k: keep(out[k]) for k in ("tb", "crc_ok", "soft_buffers")}
            cap.recs["rxc"].append(chain)
            return out

        def stage(name, fn, keys):
            """A tap on one stage of the receive chain: keeps its arguments
            (by `keys`, None for one not kept) and its outputs."""
            def tapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                if cap.chain is not None and name not in cap.chain:
                    kept = {k: keep(a) if torch.is_tensor(a) else a
                            for k, a in zip(keys, args) if k is not None}
                    outs = out if isinstance(out, tuple) else (out,)
                    kept["out"] = [keep(x) if torch.is_tensor(x) else x for x in outs]
                    cap.chain[name] = kept
                return out
            return tapped

        def dl_ext(runner, d, slot, states):
            out = o["_dl_ext"](runner, d, slot, states)
            if cap.take("dl_rx"):
                sim = runner.sims[d]
                rec = cap._rx_rec("DL", sim, slot, states[d])
                kt = rec["kt"]
                rec["net"] = {
                    "d": d,
                    "xs": [None if s is None else keep(s["port_grid"].index_select(-1, kt))
                           for s in states],
                    "h_bank": keep(runner.banks[d].h(slot).index_select(3, kt)),
                    "cells": [s.cell for s in runner.sims],
                    "links": cap.bank_links[d],
                    "cross_los": cap.cross_los,
                }
                cap.pending[("DL", id(sim))] = rec
            return out

        def ul_ext(runner, d, slot, ul_states):
            out = o["_ul_ext"](runner, d, slot, ul_states)
            if cap.take("ul_rx"):
                sim = runner.sims[d]
                rec = cap._rx_rec("UL", sim, slot, ul_states[d])
                kt = rec["kt"]
                srcs = []
                for s, st in enumerate(ul_states):
                    if s == d or st is None:
                        continue
                    srcs.append((s, keep(torch.stack(st["all_grids"]).index_select(-1, kt)),
                                 [(g.ue, len(g.prb_set)) for g, _, _, _ in st["all_items"]]))
                rec["net"] = {"d": d, "srcs": srcs, "cells": [s.cell for s in runner.sims],
                              "bank_links": cap.bank_links, "cross_los": cap.cross_los}
                cap.pending[("UL", id(sim))] = rec
            return out

        def build_banks(runner):
            if runner.banks is not None:
                return o["_build_banks"](runner)
            cap._collect = []
            try:
                out = o["_build_banks"](runner)
            finally:
                links, cap._collect = cap._collect, None
            counts = [len(runner.sims) * s.n_ues for s in runner.sims]
            starts = np.concatenate([[0], np.cumsum(counts)])
            cap.bank_links = [links[a:b] for a, b in zip(starts[:-1], starts[1:])]
            cap.net_ids |= {id(s) for s in runner.sims}
            cap.cross_los = dict(runner.cross_los)
            return out

        def build_link(*args, **kwargs):
            link = o_link(*args, **kwargs)
            if cap._collect is not None:
                cap._collect.append(link)
            return link

        def posterior(llr, bg, z, n_iter=6, norm=0.75, impl=None):
            out = o_post(llr, bg, z, n_iter, norm, impl)
            if cap.enabled and llr.is_cuda and n_iter > 0 and llr.numel():
                cap.launches.append((bg, z, out.numel() // (out.shape[-1] * out.shape[-2]),
                                     n_iter))
            rec = None
            if cap.chain is not None and "decode" not in cap.chain:
                rec = cap.chain["decode"] = {}
            elif cap.take("ldpc"):
                rec = {}
                cap.recs["ldpc"].append(rec)
            if rec is not None:
                rec.update({"llr": keep(llr), "post": keep(out), "bg": bg, "z": z,
                            "n_iter": n_iter, "norm": norm})
            return out

        def prepare_tx(sim, g, harq, n_sym, reserved=()):
            out = o["_prepare_tx"](sim, g, harq, n_sym, reserved)
            if out is not None and cap.take("tb"):
                cap._tx_tb[id(g)] = (g, np.array(out[1], np.int8, copy=True))
            return out

        def consume_due(sim, slot, due, host):
            out = o["_consume_due"](sim, slot, due, host)
            for e in due:
                if e["kind"] in ("dl", "ul") and id(e["g"]) in cap._tx_tb:
                    g, tx = cap._tx_tb.pop(id(e["g"]))
                    got = e["share"]["np"]
                    cap.recs["tb"].append({"tx": tx, "rx": np.array(got["tb"][e["i"]], np.int8),
                                           "ok": bool(got["crc_ok"][e["i"]])})
            return out

        def run_sensing(sim):
            cap.sensing_sim = sim
            try:
                return o["run_sensing"](sim)
            finally:
                cap.sensing_sim = None

        def fft_2d(rx_grid, tx_grid, params, cfg=None, *args, **kwargs):
            out = o_fft2d(rx_grid, tx_grid, params, cfg, *args, **kwargs)
            sim = cap.sensing_sim
            if sim is not None and cap.take("rdm"):
                a = int(cap.rng.integers(rx_grid.shape[0]))
                rows = min(out["rdm"].shape[-2], cfg.zone_rows[1] + 4)
                cell = sim.cell
                cap.recs["rdm"].append({
                    "a": a, "rx": keep(rx_grid), "tx": keep(tx_grid),
                    "rdm_a": keep(out["rdm"][a]), "rdm_rows": keep(out["rdm"][:, :rows]),
                    "est": {k: keep(out[k]) for k in
                            ("rngEst", "velEst", "peak", "valid", "aziEst", "doa_valid")},
                    "gnb": cell.gnb, "target": cell.target,
                    "target_positions": np.array(cell.target_positions, copy=True),
                    "target_los": np.array(cell.target_los, bool, copy=True),
                    "nfft": sim.info.nfft, "num_slots": sim.num_slots})
            return out

        for name, fn in (("_dl_rx_phase", dl_rx_phase), ("_ul_rx_phase", ul_rx_phase),
                         ("_noise", noise), ("_prepare_tx", prepare_tx),
                         ("_consume_due", consume_due), ("run_sensing", run_sensing)):
            self._patch(CS, name, fn)
        for name, fn in (("_dl_ext", dl_ext), ("_ul_ext", ul_ext), ("_build_banks", build_banks)):
            self._patch(NR, name, fn)
        self._patch(cell_mod, "sch_receive_batch", receive)
        self._patch(net_mod, "build_cdl_link", build_link)
        self._patch(ldpc_layered, "layered_posterior", posterior)
        self._patch(sen_mod, "fft_2d_estimate", fft_2d)
        for name, keys in (("estimate_channel_canonical", ("rx_c", "refs", "ports", "dsyms")),
                           ("mmse_equalize", ("y", "h", "nvar")),
                           ("demodulate_llr", ("sym", "nvar", "mod")),
                           ("descramble_llr", ("llr", "seq"))):
            self._patch(chains, name, stage(name, getattr(chains, name), keys))
        self._patch(transport, "sch_decode",
                    stage("sch_decode", transport.sch_decode, ("llr", "cfg", "rv", "soft")))

    def uninstall(self):
        while self._patches:
            owner, name, orig = self._patches.pop()
            setattr(owner, name, orig)
        self.enabled = False
