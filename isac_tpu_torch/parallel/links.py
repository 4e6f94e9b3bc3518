"""The batched PDSCH link step (counterpart of isac_tpu/parallel/links.py):
the per-link PHY transmit -> CDL channel -> receive as one tensor program
over a leading link axis, on one device or with the links sharded over a
mesh axis (the reference's ``make_sharded_link_step(g, mesh)``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from isac_tpu_torch.ops.cdl import CDLLink
from isac_tpu_torch.parallel.mesh import axis_info, gather, psum, shard
from isac_tpu_torch.phy.chains import (
    SCHGrant,
    _dmrs_refs,
    _layout,
    _make_rx_fn,
    _make_tx_fn,
    _scrambling_seq,
    grant_tbs,
)
from isac_tpu_torch.utils import tracing
from isac_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True, eq=False)
class BatchedLinks:
    """Ray constants for L links, zero-padded to a common ray count.

    H_l[t, f] = sum_r coeff_l[..., r] exp(2j pi nu_lr t) exp(-2j pi f tau_lr).
    coeff lives on the device; tau and nu stay float64 on the host. The
    engines and the banks build the frequency phases from tau on the device
    (ops/cdl.py:freq_phases_on), the time phases of each slot from nu on the
    host."""

    coeff: torch.Tensor  # [L, rx, tx, R] complex64 (zero rows where padded)
    tau: np.ndarray  # [L, R]
    nu: np.ndarray  # [L, R]


def links_from_numpy(coeff: np.ndarray, tau: np.ndarray, nu: np.ndarray,
                     device=None) -> BatchedLinks:
    """BatchedLinks from host arrays (e.g. the reference's BatchedLinks)."""
    dev = resolve_device(device)
    return BatchedLinks(
        coeff=torch.as_tensor(np.asarray(coeff, np.complex64), device=dev),
        tau=np.asarray(tau, np.float64),
        nu=np.asarray(nu, np.float64),
    )


def stack_links(links: list[CDLLink], device=None) -> BatchedLinks:
    """Stack per-link CDL constants, padding the ray axis (profiles differ in
    cluster count: CDL-A 460 rays, CDL-D 261, ...)."""
    r_max = max(l.coeff.shape[-1] for l in links)
    coeff, tau, nu = [], [], []
    for l in links:
        pad = r_max - l.coeff.shape[-1]
        coeff.append(np.pad(l.coeff, [(0, 0), (0, 0), (0, pad)]))
        tau.append(np.pad(l.tau, (0, pad)))
        nu.append(np.pad(l.nu, (0, pad)))
    return links_from_numpy(np.stack(coeff), np.stack(tau), np.stack(nu), device)


def batched_frequency_response(
    bl: BatchedLinks, t_syms: np.ndarray, freqs: np.ndarray, scale: float = 1.0
) -> torch.Tensor:
    """H[L, S, K, rx, tx] for all links at once: one contraction over rays.

    The phases are built on the host in float64 and only then cast to
    complex64, exactly as the reference does (f*tau reaches ~100 cycles; an
    f32 phase on the device would change H). The ray contraction is a plain
    complex64 matrix product whose summation order differs from XLA's, so H
    agrees with the reference to a stated rtol, not bit for bit."""
    L, n_rx, n_tx, R = bl.coeff.shape
    dev = bl.coeff.device
    tt = np.asarray(t_syms, np.float64)
    ft = np.exp(2j * np.pi * tt[None, :, None] * bl.nu[:, None, :]).astype(np.complex64)
    ff = np.exp(
        -2j * np.pi * np.asarray(freqs, np.float64)[None, :, None] * bl.tau[:, None, :]
    ).astype(np.complex64)  # [L, K, R]
    ft_t = torch.as_tensor(ft, device=dev)
    ff_t = torch.as_tensor(ff, device=dev)
    c2 = bl.coeff.reshape(L, n_rx * n_tx, R)
    ph = ft_t[:, :, None, :] * ff_t[:, None, :, :]  # [L, S, K, R]
    h = torch.matmul(ph.reshape(L, -1, R), c2.transpose(-1, -2))  # [L, S*K, A]
    return (h * scale).reshape(L, len(tt), len(freqs), n_rx, n_tx)


def make_link_step(grant: SCHGrant, n_ldpc_iter: int = 6, device=None,
                   impl: str | None = None, mesh=None, axis: str = "link"):
    """Build the batched link step: tb[L, TBS] int8, w[L, n_prg, ports, layers],
    h[L, S, K, rx, ports], noise[L, rx, S, K] -> dict(crc_ok[L], sinr_db[L],
    tb[L, TBS]). Returns (step, tbs).

    device: None means the card (raises without one). impl selects the LDPC
    decoder: None = the CUDA kernel on the card, the plain version on the
    CPU; 'torch' forces the plain version (for comparisons on the card).

    mesh: a DeviceMesh with an `axis` dimension (parallel/mesh.py). Every rank
    passes the same global inputs; it runs its block of the links, the
    outputs are all_gathered, and the dict gains n_ok, the CRC-pass count
    all_reduce'd over the axis (the cell's aggregate metric)."""
    dev = resolve_device(device)
    key = grant.layout_key()
    lay = _layout(key)
    prbs = grant.prbs
    seq = torch.as_tensor(_scrambling_seq(grant, lay["cfg"].g), device=dev)
    refs = torch.as_tensor(_dmrs_refs(grant, lay["dsyms"]), device=dev)
    tx = _make_tx_fn(key)
    rx = _make_rx_fn(key, n_ldpc_iter, impl)

    def step(tb, w, h, noise):
        grid = tx(tb, seq, refs, prbs, grant.rv, w)  # [L, P, 14, K]
        with tracing.span("pdsch.channel"):
            rxg = torch.einsum("ltsk,lskat->lask", grid, h) + noise
        out = rx(rxg, seq, refs, prbs, grant.rv)
        return {"crc_ok": out["crc_ok"], "sinr_db": out["sinr_db"], "tb": out["tb"]}

    if mesh is None:
        return step, grant_tbs(grant)
    group, r, n = axis_info(mesh, axis)

    def sharded(tb, w, h, noise):
        out = step(shard(tb, r, n), shard(w, r, n), shard(h, r, n), shard(noise, r, n))
        n_ok = psum(out["crc_ok"].to(torch.int32).sum(), group)
        return {**{k: gather(v, group) for k, v in out.items()}, "n_ok": n_ok}

    return sharded, grant_tbs(grant)
