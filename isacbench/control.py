"""Readings of the program and of the control on the card, for setting the
limits of ``reference/limits.json``.

    python3 -m isacbench.control --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, runs the cell as ``run.py`` does (untraced) and prints one
JSON line: the numbers the program reads against the reference, and the
same numbers read by the control, the reference computed one precision
below float32 in the program's place (reference/check.py). The limits lie
between the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from isacbench import harness

    if not torch.cuda.is_available():
        print("isacbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        out, checks = harness.run_cell(args.workload, seed, args.seconds, False, controls=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "program": {k: v["value"] for k, v in checks.items()},
                          "control": {k: v["value"] for k, v in out["control"].items()},
                          "compared": {k: v["n"] for k, v in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
