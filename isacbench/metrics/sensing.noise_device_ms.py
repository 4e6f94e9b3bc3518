"""sensing.noise_device_ms: device ms of the post-pass's ``sensing.noise``
span (the two threefry normal draws of the echo's noise, timed by a CUDA
event pair), the mean over the window's post-passes, one a drop. Moves
cell_slots_per_s."""

from isacbench import spans


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    device = spans.device_ms(spans.named(recs, "sensing.noise"))
    return sum(device) / len(device) if device else None
