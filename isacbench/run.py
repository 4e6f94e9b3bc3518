"""Run one cell of BENCHMARK.json once on the card and print its result line.

    python3 -m isacbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, and with --trace 1 the breakdown); the last lines
of standard error are the numbers compared with the plain reference, each
beside its limit. Without a card, or with fewer cards than the cell asks for,
the run exits with code 2 and prints no result. Kernel caches are kept in
build/ inside the checkout. Host threads are left at the libraries' own
defaults, as a user runs the program.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = CHECKOUT / "build"
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")

    import torch

    from isacbench import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"isacbench: {args.workload} needs {chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    out, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                   device="cuda", t0=T0, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"isacbench: modules loaded that the run may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} over {c['n']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
