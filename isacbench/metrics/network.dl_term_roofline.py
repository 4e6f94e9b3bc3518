"""network.dl_term_roofline: the DL cross terms' share of their roofline, %.

Numerator: for each ``network.dl_term`` span of the window, the least time
its contraction needs on the card (isacbench/dl_term_counts.py from the
span's attributes ``sources``, ``ues``, ``subcarriers``, ``rx``, ``tx``,
published H100 peaks). Denominator: those spans' device time (CUDA event
pairs). A program without the span, or a window with none, gives None.
Moves cell_slots_per_s."""

from isacbench import dl_term_counts, spans

KEYS = ("sources", "ues", "subcarriers", "rx", "tx")


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    calls = [r for r in spans.named(recs, "network.dl_term")
             if r.device_ms is not None and all(k in r.attrs for k in KEYS)]
    spent = sum(r.device_ms for r in calls) / 1e3
    if not calls or spent <= 0:
        return None
    bound = sum(dl_term_counts.call_bound_s(*(int(r.attrs[k]) for k in KEYS)) for r in calls)
    return 100.0 * bound / spent
