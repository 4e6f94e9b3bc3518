"""The measured window of each kind of traffic, one module per kind.

A traffic file (``traffic/<name>.json``) names its kind under ``kind``.
A kind's module has

- ``setup(config, traffic, seed, device, overrides) -> state``: builds what the
  window needs from the seed, warms up the cell's own shapes, and returns an
  object with ``counters()`` (the program's counters, a dict);
- ``window(state, seconds) -> (units, cell_slots)``: runs the measured work
  and returns how much of it was done; the harness synchronises the card and
  stops the clock after it returns;
- ``release(state)``: drops the program's state.

``overrides`` are keyword arguments for every engine (``n_rb_override``,
``nfft_override``), used by the CPU rehearsal and empty in a run on the card.
"""

import numpy as np


def derived_seed(seed: int, *path: int) -> int:
    """A 31-bit seed for the program, derived from the run's seed and `path`
    (the program seeds numpy with sums and products of it)."""
    return int(np.random.SeedSequence([seed % 2**64, *path]).generate_state(1)[0] & 0x7FFFFFFF)
