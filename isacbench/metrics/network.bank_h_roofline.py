"""network.bank_h_roofline: the network banks' slot responses' share of
their roofline, %.

Numerator: for each ``network.bank_h`` span of the window, the least time
its work needs on the card (isacbench/bank_counts.py from the span's
attributes ``links``, ``subcarriers``, ``delays``, ``rays``, ``ports``,
published H100 peaks). Denominator: those spans' device time (CUDA event
pairs). A program whose spans carry no such attributes, or a window with no
such span, gives None. Moves cell_slots_per_s."""

from isacbench import bank_counts, spans

KEYS = ("links", "subcarriers", "delays", "rays", "ports")


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    calls = [r for r in spans.named(recs, "network.bank_h")
             if r.device_ms is not None and all(k in r.attrs for k in KEYS)]
    spent = sum(r.device_ms for r in calls) / 1e3
    if not calls or spent <= 0:
        return None
    bound = sum(bank_counts.call_bound_s(*(int(r.attrs[k]) for k in KEYS)) for r in calls)
    return 100.0 * bound / spent
