"""build.topology_ms: per drop, host ms of the program's ``build.scenario``
(the scenario function: UE and target drop, city parameters),
``build.cells`` (validation, per-cell parameters) and ``build.los`` (the
city and every line-of-sight test) spans; the mean over the window's drops
(one ``build.scenario`` a drop). Moves cell_slots_per_s."""

from isacbench import spans


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    drops = len(spans.named(recs, "build.scenario"))
    if not drops:
        return None
    return spans.host_ms(spans.named(recs, "build.scenario", "build.cells", "build.los")) / drops
