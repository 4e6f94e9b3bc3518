"""Cell-axis sharding with inter-cell interference over collectives
(counterpart of isac_tpu/parallel/cells.py).

The reference fans cells out to parfeval workers that share nothing
(networkSimulation.m:44-55). Here each rank owns a block of destination
cells, the transmit grids are exchanged with one all_gather over the `cell`
axis, and every receiver sums ALL co-channel signals, serving and
interfering (phyRxBuffer.m:137-228 does so within one cell only).

Every function takes the same global arguments on every rank as the JAX
function takes and returns the global result on every rank: the rank's
destinations are computed locally and gathered. The contractions are plain
`torch.einsum`s (no Pallas kernel in the reference either), so results agree
with the reference to float32 summation order.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from isac_tpu_torch.parallel.mesh import axis_info, gather, shard


def _rx_from_all(tx_all, h_cols, gain_cols, noise):
    """rx[d] = sum_c gain[c, d] * H[c, d] tx[c] + noise[d] for a block of
    destinations: tx_all [C, n_tx, S, K]; h_cols [C, D, S, K, n_rx, n_tx]
    (source-indexed channel into each destination); gain_cols [C, D]
    amplitude (0 = off-channel); noise [D, n_rx, S, K]."""
    rx = torch.einsum("ctsk,cdskat,cd->dask", tx_all, h_cols,
                      gain_cols.to(tx_all.dtype))
    return rx + noise


def network_dl_step_reference(tx_grids, h_cross, gains, noise):
    """Serial reference: tx_grids [C, n_tx, S, K], h_cross [C_src, C_dst, S, K,
    n_rx, n_tx], gains [C_src, C_dst], noise [C_dst, n_rx, S, K] ->
    rx [C_dst, n_rx, S, K]."""
    return _rx_from_all(tx_grids, h_cross, gains, noise)


def network_dl_step(mesh: DeviceMesh, axis: str = "cell"):
    """Destination cells sharded over `axis`; the transmit grids are
    all_gathered so that every rank sees every co-channel transmitter.

    Returns fn(tx_grids, h_cross, gains, noise) with network_dl_step_reference's
    global arguments and result."""
    group, r, n = axis_info(mesh, axis)

    def step(tx_grids, h_cross, gains, noise):
        tx_all = gather(shard(tx_grids, r, n), group)  # [C, n_tx, S, K] on every rank
        rx = _rx_from_all(tx_all, shard(h_cross, r, n, dim=1), shard(gains, r, n, dim=1),
                          shard(noise, r, n))
        return gather(rx, group)

    return step


def network_cross_rx(mesh: DeviceMesh, axis: str = "cell"):
    """The network runner's cross-interference step: one call computes every
    destination cell's external term from every co-channel source's grid.

    Returns fn(tx_grids, h_cross, amp) -> ext [C_dst, U, n_rx, 14, K] with
    tx_grids [C, n_tx, 14, K], h_cross [C_dst, C_src, U, 14, K, n_rx, n_tx] and
    amp [C_dst, C_src, U] (self and off-channel pairs carry amp 0). Each rank
    takes its block of cells, all_gathers the transmit grids once and
    contracts only its own destinations; the result is gathered."""
    group, r, n = axis_info(mesh, axis)

    def step(tx_grids, h_cross, amp):
        tx_all = gather(shard(tx_grids, r, n), group)
        h_local = shard(h_cross, r, n)
        ext = torch.einsum("xtsk,dxuskat,dxu->duask", tx_all, h_local,
                           shard(amp, r, n).to(h_local.dtype))
        return gather(ext, group)

    return step
