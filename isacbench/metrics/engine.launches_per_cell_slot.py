"""engine.launches_per_cell_slot: device kernels the window launched, per
cell-slot, from the trace (the engine's, the PHY chains' and the ops'
dispatch; in drops also each drop's construction and sensing). Moves
cell_slots_per_s."""


def read(ctx):
    if ctx.trace is None or not ctx.cell_slots:
        return None
    lo, hi = ctx.trace.window
    n = sum(1 for _, s, e in ctx.trace.kernels if s >= lo and e <= hi)
    return n / ctx.cell_slots if n else None
