"""device.idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the card, from the union of their intervals. Moves
cell_slots_per_s."""

from isacbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    lo, hi = ctx.trace.window
    return 100.0 * (1.0 - trace.busy_ns(ctx.trace) / (hi - lo))
