"""network.cross_ms_per_slot: host ms per network slot of the runner's
cross-cell stages (``stage_s`` of ``dl_cross`` and ``ul_cross``, which hold
the banks' slot responses and the interference contractions), over the
window. Moves cell_slots_per_s."""


def read(ctx):
    before, after = ctx.counters_setup.get("stage_s"), ctx.counters_window.get("stage_s")
    if before is None or after is None:
        return None
    spent = sum(after.get(k, 0.0) - before.get(k, 0.0) for k in ("dl_cross", "ul_cross"))
    return spent * 1e3 / ctx.counters_window["num_slots"]
