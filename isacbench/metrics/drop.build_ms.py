"""drop.build_ms: per drop, host ms from the start of the harness's
``bench.drop`` range to the first ``cell.*`` range inside it: the entry, the
topology (city, line of sight) and the engine's construction (its channel
constants); the mean over the window's drops. Moves cell_slots_per_s."""

from isacbench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    drops = trace.ranges_named(ctx.trace, "bench.drop")
    cells = [r[1] for r in trace.ranges_named(ctx.trace, "cell.")]
    spans, j = [], 0
    for _, start, end in drops:
        while j < len(cells) and cells[j] < start:
            j += 1
        if j < len(cells) and cells[j] <= end:
            spans.append(cells[j] - start)
    return sum(spans) / len(spans) / 1e6 if spans else None
