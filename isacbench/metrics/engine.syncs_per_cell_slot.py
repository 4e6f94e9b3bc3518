"""engine.syncs_per_cell_slot: the times the host waited for the card in the
window (the program's ``sync`` counts: every synchronising CUDA operation,
such as a pageable upload, a readback or ``.item()``, as the tracer counts
them with CUDA's sync debug mode), per cell-slot. Moves cell_slots_per_s."""

from isacbench import spans


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None or not ctx.cell_slots:
        return None
    return sum(r.counts.get("sync", 0) for r in recs) / ctx.cell_slots
