"""network.bank_device_ms_per_slot: device ms of the network runner's
``network.bank_h`` spans (each bank's slot response: the phase product and
the ray contraction, timed by a CUDA event pair) per network slot of the
window (one ``network.slot`` span a slot). Moves cell_slots_per_s."""

from isacbench import spans


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    slots = len(spans.named(recs, "network.slot"))
    device = spans.device_ms(spans.named(recs, "network.bank_h"))
    if not slots or not device:
        return None
    return sum(device) / slots
