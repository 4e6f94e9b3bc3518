"""control.host_ms_per_cell_slot: host ms of the engine's control-plane
ranges (``cell.plan``: scheduling, RLC and MAC, transport blocks;
``cell.tick``: traffic, timers, due feedback) per cell-slot of the window.
Moves cell_slots_per_s."""

from isacbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.cell_slots:
        return None
    ranges = [r for r in trace.ranges_named(ctx.trace, "cell.") if r[0] in ("cell.plan", "cell.tick")]
    if not ranges:
        return None
    return sum(e - s for _, s, e in ranges) / 1e6 / ctx.cell_slots
