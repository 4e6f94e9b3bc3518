"""The batched PDSCH link step (counterpart of isac_tpu/parallel/links.py):
the per-link PHY transmit -> CDL channel -> receive as one tensor program
over a leading link axis, on one device or with the links sharded over a
mesh axis (the reference's ``make_sharded_link_step(g, mesh)``). The batch of
links and its frequency response are the channel layer's (ops/cdl.py), named
here as in the reference.
"""

from __future__ import annotations

import torch

from isac_tpu_torch.ops.cdl import (
    BatchedLinks,
    batched_frequency_response,
    links_from_numpy,
    stack_links,
)
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
