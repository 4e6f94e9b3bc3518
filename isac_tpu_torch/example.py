"""Example inputs of the port's two headline paths.

`example_sensing`: the mono-static sensing chain at the reference benchmark's
inputs (default gNB, one target, a QPSK-filled DL grid on every slot).

`example_link_batch`: the batched PDSCH link step (numpy counterpart of the
reference's ``__graft_entry__._example_link_batch``): 16-port gNB (8 cross-polarized
pairs at half-wavelength) to 2-antenna UEs over alternating CDL-D / CDL-A
links at 3.5 GHz, SCS 30 kHz, random Type-1 PRG precoders and unit-variance
noise, all drawn from one numpy seed so that the reference and the port see
the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from isac_tpu_torch.config.params import ULA, GNBParams
from isac_tpu_torch.ops.cdl import build_cdl_link, subcarrier_freqs
from isac_tpu_torch.ops.precoding import csirs_panel_dims, type1_codebook
from isac_tpu_torch.parallel.links import batched_frequency_response, stack_links
from isac_tpu_torch.phy.chains import SCHGrant, grant_tbs
from isac_tpu_torch.sim.sensing import make_sensing_chain
from isac_tpu_torch.utils.device import resolve_device

N_TX, N_RX = 16, 2


def example_links(n_links: int, seed: int = 0):
    """The example's per-link CDL constants (numpy CDLLinks)."""
    lam = 3e8 / 3.5e9
    etx = np.stack([np.zeros(N_TX), np.repeat(np.arange(8), 2) * 0.5 * lam,
                    np.zeros(N_TX)], -1)
    erx = np.stack([np.zeros(N_RX), np.arange(N_RX) * 0.5 * lam, np.zeros(N_RX)], -1)
    return [
        build_cdl_link("CDL-D" if i % 2 == 0 else "CDL-A", 300.0, 3.5e9, etx, erx,
                       ue_velocity=0.43, seed=seed + i)
        for i in range(n_links)
    ]


def example_link_batch(n_prb=51, n_links=4, mcs=19, n_layers=2, seed=0, device=None):
    """(grant, (tb, w, h, noise), tbs) with the tensors on `device`
    (None = the card)."""
    dev = resolve_device(device)
    n_sc = n_prb * 12
    bl = stack_links(example_links(n_links, seed), device=dev)
    t = np.arange(14) * (5e-4 / 14)
    h = batched_frequency_response(bl, t, subcarrier_freqs(n_sc, 30e3), scale=1579.0)
    g = SCHGrant(n_prb=n_prb, n_layers=n_layers, mcs=mcs, n_sc_grid=n_sc)
    tbs = grant_tbs(g)
    rng = np.random.default_rng(seed)
    tb = torch.as_tensor(rng.integers(0, 2, (n_links, tbs)).astype(np.int8), device=dev)
    n1, n2 = csirs_panel_dims(N_TX)
    cb = type1_codebook(n1, n2, n_layers)
    n_prg = (n_prb + 1) // 2
    w = torch.as_tensor(
        np.stack([cb[rng.integers(0, cb.shape[0], n_prg)] for _ in range(n_links)]),
        device=dev,
    )  # [L, n_prg, ports, layers]
    noise = torch.as_tensor(
        ((rng.standard_normal((n_links, N_RX, 14, n_sc))
          + 1j * rng.standard_normal((n_links, N_RX, 14, n_sc))) * np.sqrt(0.5)
         ).astype(np.complex64),
        device=dev,
    )
    return g, (tb, w, h, noise), tbs


def example_sensing(num_slots=20, seed=0, device=None, gnb=None,
                    targets=(((120.0, 40.0, 1.5),), (1.0,), (7.0,))):
    """(chain, params, grids) of the sensing chain at the reference benchmark's
    inputs: the default gNB (3.5 GHz, 100 MHz at SCS 30 kHz = 273 PRB, 8x2-pol
    ULA, 44 dBm), one target at (120, 40, 1.5) m with RCS 1 m^2 and 7 m/s, and a
    +-1 +-1j QPSK grid on all `num_slots` slots from one numpy seed, scaled by the
    reference amplitude law 10^((P_dBm-30)/20) * sqrt(nfft^2 / (n_sc * n_tx)).

    targets is (positions [T, 3], rcs [T], radial velocities [T]); gnb overrides
    the default GNBParams (a narrower carrier for tests). `chain(grids, gen)`
    runs the 2D-FFT chain with MUSIC DoA (sim/sensing.py:make_sensing_chain);
    the grid is one tensor on `device` (None = the card) spanning all slots."""
    dev = resolve_device(device)
    if gnb is None:
        gnb = GNBParams(antenna=ULA(n_v=8, polarizations=2))
    carrier = gnb.carrier
    info, n_sc, n_tx = carrier.ofdm, carrier.n_sc, gnb.num_tx_ants
    n_sym = num_slots * info.symbols_per_slot
    rng = np.random.default_rng(seed)
    grid = (
        (rng.integers(0, 2, (n_tx, n_sym, n_sc)) * 2 - 1)
        + 1j * (rng.integers(0, 2, (n_tx, n_sym, n_sc)) * 2 - 1)
    ).astype(np.complex64) / np.sqrt(2)
    amp = float(10 ** ((gnb.tx_power_dbm - 30) / 20) * np.sqrt(info.nfft**2 / (n_sc * n_tx)))
    pos, rcs, vel = targets
    chain, params = make_sensing_chain(
        gnb, carrier, pos, rcs, vel, num_slots, starts=(0,), widths=(n_sym,), device=dev,
    )
    grid_dev = torch.as_tensor(grid.astype(np.complex64), device=dev) * amp
    return chain, params, (grid_dev,)
