"""ldpc_layered_roofline: the layered LDPC kernel's share of its roofline, %.

Numerator: for each launch of the window, the least time its (base graph,
lifting size, codewords, iterations) needs on the card (isacbench/
ldpc_counts.py, published H100 peaks); the shapes come from the harness's
tap on the decoder, in launch order. Denominator: the device time of the
``ldpc_layered`` kernels in the trace, paired with the launches in order.
Nothing to read (no launch, or a count that does not pair) gives None.
Moves cell_slots_per_s."""

import sys

from isacbench import ldpc_counts


def read(ctx):
    if ctx.trace is None or not ctx.launches:
        return None
    lo, hi = ctx.trace.window
    kern = [(s, e) for name, s, e in ctx.trace.kernels
            if "ldpc_layered" in name and s >= lo and e <= hi]
    if len(kern) != len(ctx.launches):
        print(f"ldpc_layered_roofline: {len(kern)} kernels for {len(ctx.launches)} launches",
              file=sys.stderr)
        return None
    bound = sum(ldpc_counts.launch_bound_s(bg, z, b, it) for bg, z, b, it in ctx.launches)
    spent = sum(e - s for s, e in kern) / 1e9
    return 100.0 * bound / spent
