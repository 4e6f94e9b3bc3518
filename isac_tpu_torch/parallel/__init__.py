"""Distribution over torch.distributed (counterpart of isac_tpu/parallel):
named meshes of ranks in place of JAX's device meshes, per-rank code with
collectives in place of shard_map.

Three mesh axes, composable:
- `link`: the batched PDSCH link step sharded over links, with the CRC-pass
  count all_reduce'd (links.py make_link_step(mesh=); the reference's
  make_sharded_link_step);
- `cell`: the multi-cell downlink step with inter-cell interference, the
  transmit grids all_gathered over the axis (cells.py);
- `time`: the sensing slow-time (Doppler) DFT over OFDM-symbol blocks, a
  local DFT matmul and an all_reduce (time_blocks.py).
"""

from isac_tpu_torch.parallel.cells import (
    network_cross_rx,
    network_dl_step,
    network_dl_step_reference,
)
from isac_tpu_torch.parallel.distributed import global_mesh, init_distributed
from isac_tpu_torch.parallel.links import (
    BatchedLinks,
    batched_frequency_response,
    make_link_step,
    stack_links,
)
from isac_tpu_torch.parallel.mesh import make_mesh
from isac_tpu_torch.parallel.time_blocks import range_doppler_map_sharded

__all__ = [
    "global_mesh", "init_distributed",
    "make_mesh",
    "BatchedLinks",
    "batched_frequency_response",
    "make_link_step",
    "stack_links",
    "network_cross_rx",
    "network_dl_step",
    "network_dl_step_reference",
    "range_doppler_map_sharded",
]
