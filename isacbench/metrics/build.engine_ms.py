"""build.engine_ms: per drop, host ms of the program's ``build.engine`` spans
(the engine's constructor: link budget, the CDL link draws, the stacked ray
constants with their host float64 frequency phases and upload, the protocol
state); the mean over the window's drops (one ``build.scenario`` a drop).
Moves cell_slots_per_s."""

from isacbench import spans


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    drops = len(spans.named(recs, "build.scenario"))
    engines = spans.named(recs, "build.engine")
    if not drops or not engines:
        return None
    return spans.host_ms(engines) / drops
