"""The mono-static sensing post-pass as one function on tensors.

Counterpart of the closure `_sensing_chain` that the reference's per-slot
engine builds in `CellSim.run_sensing` (cellSimulation.m:189-202): the DL
resource grids that the gNB transmitted are reassembled into one grid (zeros on
slots without DL), OFDM-modulated, sent through the radar echo channel,
demodulated and handed to the 2D-FFT chain (RDM -> CA-CFAR -> DoA) or to the
range/velocity MUSIC chain. No engine state: everything the chain needs comes
in as arguments, and the random draw is the caller's generator.

Each stage runs inside a span ``sensing.<stage>`` (utils/tracing.py;
assemble, ofdm_modulate, echo, ofdm_demodulate here; rdm, cfar, doa, music_2d
in ops/sensing).
"""

from __future__ import annotations

import numpy as np
import torch

from isac_tpu_torch.ops.ofdm import ofdm_demodulate, ofdm_modulate
from isac_tpu_torch.ops.sensing import (
    apply_radar_channel,
    derive_radar_params,
    fft_2d_estimate,
    make_cfar_config,
    music_2d_estimate,
)
from isac_tpu_torch.parallel.time_blocks import range_doppler_map_sharded
from isac_tpu_torch.utils import tracing
from isac_tpu_torch.utils.device import resolve_device


def make_sensing_chain(
    gnb,
    carrier,
    target_positions,
    target_rcs,
    target_velocity,
    num_slots: int,
    starts: tuple,
    widths: tuple,
    target_los=None,
    algo: str = "FFT",
    doa_method: str = "music",
    device=None,
    mesh=None,
    mesh_axis: str = "time",
):
    """Build the sensing chain of one cell. Returns (chain, params).

    starts/widths: the slots that carried DL and the number of symbols each of
    their grids holds (14 for a D slot, the DL symbols of an S slot).
    chain(grids, noise_or_generator=None) takes one [n_tx, width, n_sc] complex
    grid per entry of `starts` on `device`, and a `torch.Generator` (AWGN is
    drawn from it), a ready-made [N, n_ants] complex64 noise array, or None (no
    noise); it returns the estimate dict of `fft_2d_estimate` (algo 'FFT',
    with the RDM) or `music_2d_estimate` (algo 'MUSIC').
    params is the RadarDerived the chain works with (truth for `get_rmse`).

    device: None means the card (raises without one). mesh: a DeviceMesh whose
    `mesh_axis` dimension shards the FFT chain's RDM over symbol blocks
    (parallel/time_blocks.py); every rank passes the same grids.
    """
    dev = resolve_device(device)
    algo = algo.upper()
    if algo not in ("FFT", "MUSIC"):
        raise ValueError(f"est_algorithm must be FFT|MUSIC, got {algo!r}")
    if len(starts) != len(widths):
        raise ValueError("starts and widths differ in length")
    params = derive_radar_params(
        gnb, carrier, np.asarray(target_positions, np.float64),
        np.asarray(target_rcs, np.float64), np.asarray(target_velocity, np.float64),
        num_slots,
    )
    cfg = make_cfar_config(params)
    info, n_sc, n_tx = carrier.ofdm, carrier.n_sc, gnb.num_tx_ants
    sps = info.symbols_per_slot
    los = None if target_los is None else np.asarray(target_los, bool)
    rdm_fn = None
    if mesh is not None and algo == "FFT":
        rdm_fn = range_doppler_map_sharded(mesh, num_slots * sps, n_sc, params.n_ifft,
                                           params.n_fft, axis=mesh_axis)

    def chain(grids, noise_or_generator=None):
        if len(grids) != len(starts):
            raise ValueError(f"{len(grids)} grids for {len(starts)} DL slots")
        generator = noise = None
        if isinstance(noise_or_generator, torch.Generator):
            generator = noise_or_generator
        else:
            noise = noise_or_generator
        with tracing.span("sensing.assemble"):
            tx_grid = torch.zeros((n_tx, num_slots * sps, n_sc), dtype=torch.complex64,
                                  device=dev)
            for st, wdt, g in zip(starts, widths, grids):
                tx_grid[:, st * sps: st * sps + wdt, :] = g
        with tracing.span("sensing.ofdm_modulate"):
            tx_wave = ofdm_modulate(tx_grid, info).T  # [N, n_tx]
        with tracing.span("sensing.echo"):
            rx = apply_radar_channel(tx_wave, params, generator, los, noise)
            del tx_wave
        with tracing.span("sensing.ofdm_demodulate"):
            rx_grid = ofdm_demodulate(rx.T, info, n_sc, num_slots)
            del rx
        if algo == "MUSIC":
            return music_2d_estimate(rx_grid, tx_grid, params, doa_method=doa_method)
        rdm = None
        if rdm_fn is not None:
            with tracing.span("sensing.rdm"):
                rdm = rdm_fn(rx_grid, tx_grid)
        return fft_2d_estimate(rx_grid, tx_grid, params, cfg, doa_method=doa_method, rdm=rdm)

    return chain, params
