"""Slow-time (Doppler) axis sharding of the sensing range-Doppler map
(counterpart of isac_tpu/parallel/time_blocks.py).

The reference FFTs the whole symbol axis of the frame's DL grid at the end
(gNBPhy.m:604-612, fft2D.m:44-46). Here each rank owns a block of OFDM
symbols: it keeps the reciprocal filter and the range IFFT local, and the
slow-time FFT becomes a LOCAL DFT matmul against the block's twiddle columns,
summed over the `time` axis by one all_reduce:

    RDM[., d] = sum_m W[d, m] r[., m]  =  sum_blocks ( W[:, block] @ r_block )
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from isac_tpu_torch.ops import dft
from isac_tpu_torch.parallel.mesh import axis_info, mesh_device, psum, shard
from isac_tpu_torch.utils.windows import window


def range_doppler_map_sharded(
    mesh: DeviceMesh,
    n_sym: int,
    n_sc: int,
    n_ifft: int,
    n_fft: int,
    axis: str = "time",
    win: str = "kaiser",
):
    """Build the sharded RDM: fn(rx_grid, tx_grid) with the global grids
    [n_ants, n_sym, n_sc] on every rank; each rank works on its block of
    symbols. The RDM [n_ants, n_ifft, n_fft] is the all_reduce'd sum, the same
    on every rank, in ops.sensing.rdm.range_doppler_map's layout and
    normalisation (Doppler axis fftshift-centred).

    The rank's DFT columns are built here, once, on the mesh's device."""
    group, r, n_dev = axis_info(mesh, axis)
    if n_sym % n_dev:
        raise ValueError(f"{n_sym} symbols do not split into {n_dev} blocks")
    block = n_sym // n_dev
    dev = mesh_device(mesh)
    rng_win = torch.as_tensor(window(win, n_sc).astype(np.float32), device=dev)
    dop_win_full = np.asarray(window(win, n_sym), np.float64)
    # DFT matrix columns for each symbol, fftshift folded in:
    # rdm[d] = sum_m exp(-2j pi ((d - n_fft/2) mod n_fft) m / n_fft) r[m]
    d_idx = (np.arange(n_fft) + n_fft // 2) % n_fft  # output row -> DFT bin
    m_idx = np.arange(n_sym)
    w_full = np.exp(-2j * np.pi * np.outer(d_idx, m_idx) / n_fft) / np.sqrt(n_fft)
    w_full = (w_full * dop_win_full[None, :]).astype(np.complex64)  # [n_fft, n_sym]
    if n_sym > n_fft:
        # fft(x, n=n_fft) TRUNCATES to the first n_fft samples; match it
        w_full[:, n_fft:] = 0.0
    w_b = torch.as_tensor(np.ascontiguousarray(w_full[:, r * block:(r + 1) * block]),
                          device=dev)  # [n_fft, block]

    def call(rx_grid, tx_grid):
        rx_b, tx_b = shard(rx_grid, r, n_dev, dim=1), shard(tx_grid, r, n_dev, dim=1)
        h = rx_b * torch.conj(tx_b) * rng_win
        rr = dft.ifft_auto(h, n=n_ifft, axis=-1) * float(np.sqrt(n_ifft))  # [a, blk, n_ifft]
        del h
        # local Doppler partial: [n_fft, blk] @ [a, blk, n_ifft] -> [a, n_ifft, n_fft]
        part = torch.einsum("dm,amr->ard", w_b, rr)
        return psum(part, group)

    return call
