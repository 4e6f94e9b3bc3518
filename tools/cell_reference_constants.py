"""Reference numbers of the JAX engine for the port's chip smoke test.

Runs isac_tpu's CellSimulator on the shipped open_street_map_city scenario
(273 PRB, nfft 4096, 16 gNB ports, 5 two-antenna UEs, one target, seed 0,
one frame) on the JAX CPU backend and prints one JSON object: per-UE DL/UL
transport block counts, CRC failures and throughputs, the sensing detections
(range, velocity, azimuth) and the per-slot trace's integer fields.
chip_smoke.py phase 7b holds the port's run on the card against these numbers.

Run from the repository root:

    python tools/cell_reference_constants.py [--n-rb N --nfft N] > out.json

(without arguments: the full width; it takes a few GB of memory and several
minutes on a CPU).
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

from isac_tpu.config.params import SimulationParameters, assign_cell_parameters  # noqa: E402
from isac_tpu.config.scenarios import open_street_map_city  # noqa: E402
from isac_tpu.sim.cell import CellSimulator  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-rb", type=int, default=None)
    ap.add_argument("--nfft", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cell = assign_cell_parameters(open_street_map_city(SimulationParameters()))[0]
    cell = replace(cell, log=replace(cell.log, enable_traces=True))
    t0 = time.perf_counter()
    cs = CellSimulator(cell, seed=args.seed, n_rb_override=args.n_rb,
                       nfft_override=args.nfft)
    res = cs.run()
    secs = time.perf_counter() - t0
    comm = res["communication"]
    est = res["sensing"]["estimates"]
    valid = np.asarray(est["valid"], bool)
    out = {
        "n_rb": cs.n_rb, "nfft": cs.info.nfft, "n_tx": cs.n_tx, "n_ues": cs.n_ues,
        "seed": args.seed, "jax": jax.__version__, "seconds": secs,
        "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "dl_tbs": [c.blk_total for c in cs.metrics.dl],
        "dl_crc_fail": [c.blk_err for c in cs.metrics.dl],
        "ul_tbs": [c.blk_total for c in cs.metrics.ul],
        "ul_crc_fail": [c.blk_err for c in cs.metrics.ul],
        "dl_mbps": [float(x) for x in comm["ueDLThroughputMbps"]],
        "ul_mbps": [float(x) for x in comm["ueULThroughputMbps"]],
        "detections": int(valid.sum()),
        # NaN (no estimate) as null
        **{k: [None if np.isnan(x) else float(x) for x in np.asarray(est[k], np.float64)]
           for k in ("rngEst", "velEst", "aziEst")},
        "rmse": {k: float(v) for k, v in res["sensing"]["rmse"].items()
                 if k.endswith("RMSE") or k.startswith("num")},
        "trace": [[t["slot"], t["dir"], t["ue"], t["mcs"], t["n_prb"], t["tbs"],
                   int(t["crc"]), t["rv"]] for t in cs.metrics.trace],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
