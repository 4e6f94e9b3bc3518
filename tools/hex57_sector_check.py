"""Hold a sample of the 57-TRxP drop's links, as the port draws them, to the
plain float64 reference of a sector's link (isacbench/reference/sector.py).

    python3 tools/hex57_sector_check.py [--device cuda] [--n-rb 273] [--samples 48]

Builds the uma-hex57 configuration's drop as the benchmark's steady kind does
(the scenario at the traffic's drop_seed, the city's line of sight) and its
`SyncNetworkRunner` with every bank, at the given width, keeping each link the
engines and the banks draw. For a sample of serving links (DL: the gNB
departs, UL: it receives) and of bank links (gNB s -> UE u of destination
d), the reference recomputes the link from the geometry alone: TRxP k's
boresight 30 + 120 (k % 3) deg and 12 deg tilt, the azimuth and zenith from
its site to the UE; the profile (the city's line of sight), seed, element
positions and UE speed are the program's call. Prints one JSON line with the
worst max |d coeff| / max |coeff| of each kind and exits 1 above 1e-5.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOL = 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-rb", type=int, default=273)
    ap.add_argument("--nfft", type=int, default=None)
    ap.add_argument("--samples", type=int, default=48)
    args = ap.parse_args(argv)

    import isac_tpu_torch.sim.cell as cell_mod
    import isac_tpu_torch.sim.network as net_mod
    from isac_tpu_torch.config import scenarios
    from isac_tpu_torch.config.params import SimulationParameters, TimeParams, assign_cell_parameters
    from isacbench.reference.sector import sector_link

    config = json.loads((ROOT / "isacbench/configs/uma-hex57.json").read_text())
    traffic = json.loads((ROOT / "isacbench/traffic/steady-1f.json").read_text())
    t0 = time.perf_counter()
    sim = getattr(scenarios, config["scenario"])(SimulationParameters(),
                                                 seed=int(traffic["drop_seed"]),
                                                 **config["scenario_kwargs"])
    sim.time = TimeParams(num_frames=1)
    cells, cross = net_mod.resolve_los_cross(assign_cell_parameters(sim), sim)
    calls = []
    orig = net_mod.build_cdl_link

    def keep(*a, **kw):
        calls.append((a, kw, orig(*a, **kw)))
        return calls[-1][2]

    cell_mod.build_cdl_link = net_mod.build_cdl_link = keep
    try:
        kw = dict(n_rb_override=args.n_rb, nfft_override=args.nfft) if args.n_rb != 273 else {}
        runner = net_mod.SyncNetworkRunner(cells, seed=1, cross_los=cross, device=args.device,
                                           enable_sensing=False, **kw)
        runner._build_banks()
    finally:
        cell_mod.build_cdl_link = net_mod.build_cdl_link = orig
    build_s = time.perf_counter() - t0
    n, u_n = len(cells), cells[0].ue_positions.shape[0]
    assert len(calls) == n * 2 * u_n + n * n * u_n, len(calls)

    def serving(k, u, end):
        return calls[k * 2 * u_n + (0 if end == "tx" else u_n) + u]

    def bank(d, s, u):
        return calls[n * 2 * u_n + (d * n + s) * u_n + u]

    rng = np.random.default_rng(57)
    picks = [("serving_dl", (k, u, "tx"), k, cells[k].ue_positions[u])
             for k, u in zip(rng.integers(n, size=args.samples // 4),
                             rng.integers(u_n, size=args.samples // 4))]
    picks += [("serving_ul", (k, u, "rx"), k, cells[k].ue_positions[u])
              for k, u in zip(rng.integers(n, size=args.samples // 4),
                              rng.integers(u_n, size=args.samples // 4))]
    picks += [("bank", (d, s, u), s, cells[d].ue_positions[u])
              for d, s, u in zip(rng.integers(n, size=args.samples // 2),
                                 rng.integers(n, size=args.samples // 2),
                                 rng.integers(u_n, size=args.samples // 2))]
    worst: dict = {}
    for kind, key, trxp, ue_pos in picks:
        a, kwargs, link = serving(*key) if kind != "bank" else bank(*key)
        end = "rx" if kind == "serving_ul" else "tx"
        site = np.asarray(cells[trxp].gnb.position, np.float64)
        rel = np.asarray(ue_pos, np.float64) - site
        azimuth = np.degrees(np.arctan2(rel[1], rel[0]))
        zenith = 90.0 + np.degrees(np.arctan((site[2] - ue_pos[2]) / np.hypot(rel[0], rel[1])))
        profile, ds, fc, tx, rx = a
        coeff, tau, nu = sector_link(profile, ds, fc, tx, rx, kwargs["ue_velocity"],
                                     kwargs["seed"], 30.0 + 120.0 * (trxp % 3), 12.0,
                                     azimuth, zenith, end)
        want = coeff.numpy()
        err = float(np.abs(link.coeff - want).max() / np.abs(want).max())
        assert np.array_equal(link.tau, tau.numpy()) and np.allclose(link.nu, nu.numpy(),
                                                                     rtol=1e-12, atol=1e-12)
        worst[kind] = max(worst.get(kind, 0.0), err)
    out = {"trxps": n, "ues": u_n, "links_drawn": len(calls), "n_rb": args.n_rb,
           "device": args.device, "build_s": build_s, "compared": len(picks),
           "worst": worst, "limit": TOL, "ok": all(v <= TOL for v in worst.values())}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
