"""One rank of a multi-process torch.distributed run of isac_tpu_torch's
parallel/ functions on the CPU (gloo).

    python tools/torch_mp_worker.py HOST:PORT WORLD RANK INPUTS.npz OUT_DIR

Every rank joins the world through init_distributed, loads the same global
inputs and runs, each over a mesh of all ranks:

- make_link_step(mesh=) on the `link` axis (links sharded, the CRC-pass
  count all_reduce'd, the outputs gathered);
- network_dl_step and network_cross_rx on the `cell` axis (transmit grids
  all_gathered);
- range_doppler_map_sharded on the `time` axis (a DFT matmul per symbol
  block, all_reduce'd);
- global_mesh's size inference ({"cell": 2, "time": -1}) and its refusal of
  sizes that do not fit the world ({"cell": 3}).

It writes OUT_DIR/rank<RANK>.npz and prints one JSON line. It imports
neither jax nor isac_tpu, and runs one torch thread.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main():
    coord, world, rank, inputs, out_dir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                           sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    from isac_tpu_torch.parallel import (
        global_mesh,
        init_distributed,
        make_link_step,
        network_cross_rx,
        network_dl_step,
        range_doppler_map_sharded,
    )
    from isac_tpu_torch.phy.chains import SCHGrant

    info = init_distributed(coord, num_processes=world, process_id=rank, device="cpu")
    data = np.load(inputs)
    g = SCHGrant(**json.loads(str(data["grant"])))
    x = {k: torch.as_tensor(v) for k, v in data.items() if k != "grant"}
    out = {}

    step, _ = make_link_step(g, device="cpu", mesh=global_mesh({"link": -1}))
    res = step(x["tb"], x["w"], x["h"], x["noise"])
    out.update({f"link_{k}": v.numpy() for k, v in res.items()})

    mesh_c = global_mesh({"cell": -1})
    out["dl_rx"] = network_dl_step(mesh_c)(x["txg"], x["hc"], x["gains"], x["nz"]).numpy()
    out["cross_ext"] = network_cross_rx(mesh_c)(x["txg2"], x["hx"], x["ampx"]).numpy()

    n_ants, n_sym, n_sc = x["rx_grid"].shape
    rdm = range_doppler_map_sharded(global_mesh({"time": -1}), n_sym, n_sc,
                                    int(x["n_ifft"]), int(x["n_fft"]))
    out["rdm"] = rdm(x["rx_grid"], x["tx_grid"]).numpy()

    sizes = None
    if world % 2 == 0:
        m = global_mesh({"cell": 2, "time": -1})
        sizes = [int(s) for s in m.shape]
    refused = False
    if world % 3:
        try:
            global_mesh({"cell": 3})
        except ValueError:
            refused = True
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(json.dumps({**info, "inferred_sizes": sizes, "refused_cell_3": refused}))


if __name__ == "__main__":
    main()
