"""network.bank_gib: the most the network banks held on the device at once,
GiB: their constants after the build and the slot responses they cached,
over set-up and window (the program's ``network.bank_bytes`` count, made
once a ``network.slot`` span with the runner's running maximum; the largest
in the window). A program without the count gives None. Moves
peak_mem_gib."""

from isacbench import spans


def read(ctx):
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    held = [r.counts["network.bank_bytes"] for r in recs if "network.bank_bytes" in r.counts]
    return max(held) / 2**30 if held else None
