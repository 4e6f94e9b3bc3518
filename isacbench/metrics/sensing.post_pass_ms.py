"""sensing.post_pass_ms: host ms of the engine's ``cell.sensing`` range (echo,
range-Doppler map, CFAR, MUSIC DoA and their readback) per drop, the mean
over the window. Moves cell_slots_per_s."""

from isacbench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    ranges = [r for r in trace.ranges_named(ctx.trace, "cell.sensing") if r[0] == "cell.sensing"]
    return sum(e - s for _, s, e in ranges) / len(ranges) / 1e6 if ranges else None
