"""Reference numbers of the JAX network for the port's chip smoke test.

Runs isac_tpu on its JAX CPU backend through the two top-level paths that
chip_smoke.py phase 8 drives on the card, and prints one JSON object:

- "city_entry": `simulate(open_street_map_city)` as shipped (the README's
  quick start: one cell, 273 PRB, nfft 4096, 16 gNB ports, 5 two-antenna UEs
  whose line of sight the synthetic city resolves, one target, seed 0, one
  frame), with what its result dict carries: per-UE DL/UL BLER and
  throughput, the detections (range, velocity, azimuth);
- "network": `multi_cell(num_cells)` (2 cells unless `--num-cells` says
  otherwise; chip_smoke.py phase 8c runs 2, phase 10 runs 7) through
  `resolve_los_cross` and the lockstep `SyncNetworkRunner` with DL + UL
  co-channel interference and traces (seed 0, sensing on), per cell: the LoS
  of its UEs, transport block counts, CRC failures, BLER, throughputs,
  detections (with the DoA valid flags) and the per-slot trace's integer
  fields; plus the cross-cell LoS map and the network totals.

Run from the repository root:

    PYTHONPATH=. python tools/network_reference_constants.py [--num-cells N] \
        [--n-rb N --nfft N] > out.json

(without arguments: 2 cells at the full width; the network takes ~6 GB of
memory and a few minutes on a CPU, the city entry ~3 GB and about a minute.
Seven cells at the full width hold seven engines and seven banks of 35 links.)
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from dataclasses import replace

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

import numpy as np  # noqa: E402

from isac_tpu.api import simulate  # noqa: E402
from isac_tpu.config.params import SimulationParameters, assign_cell_parameters  # noqa: E402
from isac_tpu.config.scenarios import multi_cell, open_street_map_city  # noqa: E402
from isac_tpu.sim.network import SyncNetworkRunner, resolve_los_cross  # noqa: E402


def _floats(x) -> list:
    """Floats of an array, NaN (no estimate) as null."""
    return [None if np.isnan(v) else float(v) for v in np.asarray(x, np.float64).reshape(-1)]


def _result_numbers(res: dict) -> dict:
    """What one cell's result dict carries: KPIs and detections."""
    comm = res["communication"]
    out = {k: _floats(comm[k]) for k in ("ueDLBLER", "ueULBLER", "ueDLThroughputMbps",
                                          "ueULThroughputMbps")}
    sen = res["sensing"]
    if sen is not None:
        est = sen["estimates"]
        out["detections"] = int(np.asarray(est["valid"], bool).sum())
        out.update({k: _floats(est[k]) for k in ("rngEst", "velEst", "aziEst")})
        out.update({k: [bool(x) for x in np.asarray(est[k], bool)]
                    for k in ("valid", "doa_valid")})
        out["rmse"] = {k: float(v) for k, v in sen["rmse"].items()
                       if k.endswith("RMSE") or k.startswith("num")}
    return out


def city_entry(n_rb, nfft) -> dict:
    t0 = time.perf_counter()
    res = simulate(open_street_map_city, n_rb_override=n_rb, nfft_override=nfft)
    cell = res["cells"][0]
    return {"seconds": time.perf_counter() - t0, **_result_numbers(cell),
            "totalDLThroughputMbps": res["network"]["totalDLThroughputMbps"],
            "totalULThroughputMbps": res["network"]["totalULThroughputMbps"]}


def network(n_rb, nfft, num_cells) -> dict:
    sim = multi_cell(SimulationParameters(), num_cells=num_cells)
    sim.validate()
    cells, cross_los = resolve_los_cross(assign_cell_parameters(sim), sim)
    cells = [replace(c, log=replace(c.log, enable_traces=True)) for c in cells]
    t0 = time.perf_counter()
    runner = SyncNetworkRunner(cells, seed=0, cross_los=cross_los, n_rb_override=n_rb,
                               nfft_override=nfft)
    results = runner.run()
    secs = time.perf_counter() - t0
    s0 = runner.sims[0]
    per_cell = []
    for sim_c, cell, res in zip(runner.sims, cells, results):
        per_cell.append({
            "ue_los": [bool(x) for x in cell.ue_los],
            "dl_tbs": [c.blk_total for c in sim_c.metrics.dl],
            "dl_crc_fail": [c.blk_err for c in sim_c.metrics.dl],
            "ul_tbs": [c.blk_total for c in sim_c.metrics.ul],
            "ul_crc_fail": [c.blk_err for c in sim_c.metrics.ul],
            **_result_numbers(res),
            "trace": [[t["slot"], t["dir"], t["ue"], t["mcs"], t["n_prb"], t["tbs"],
                       int(t["crc"]), t["rv"]] for t in sim_c.metrics.trace],
        })
    return {
        "num_cells": len(runner.sims), "n_rb": s0.n_rb, "nfft": s0.info.nfft, "n_tx": s0.n_tx,
        "n_ues": s0.n_ues, "seconds": secs,
        "cross_los": {f"{d},{s}": [bool(x) for x in v] for (d, s), v in sorted(cross_los.items())},
        "bank_rays": [b.links.n_rays for b in runner.banks],
        "cells": per_cell,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-rb", type=int, default=None)
    ap.add_argument("--nfft", type=int, default=None)
    ap.add_argument("--num-cells", type=int, default=2)
    args = ap.parse_args()
    out = {"jax": jax.__version__,
           "city_entry": city_entry(args.n_rb, args.nfft),
           "network": network(args.n_rb, args.nfft, args.num_cells)}
    out["peak_rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps(out))


if __name__ == "__main__":
    main()
