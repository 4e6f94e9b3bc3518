"""The decoder kernel against the first version of its source, in one process.

    git show <commit of the first version>:isac_tpu_torch/csrc/ldpc_layered.cu \\
        > build/ldpc_layered_v1.cu
    python3 -m isac_tpu_torch.compare_v1_kernel build/ldpc_layered_v1.cu

The first version kept one float message per edge and lane in device memory
([B, E, z], zero-filled by its wrapper before every launch) and took
(llr, out, msg, row_ptr, edge_col, edge_shift, n_cw, n_rows, n_cols, n_edges,
max_deg, z, n_iter, norm, stream). This script builds that source with the
package's nvcc flags, checks that both kernels give the same posterior bits at
the main path's shape (116 codewords x BG1 Z=384 x 6 sweeps), and times them
in turns (old, new, new, old) with CUDA events, each reading the mean of 20
calls over 4 distinct inputs, the old one with its zero-fill as its wrapper
ran it. Then it times the new kernel alone at 1, 6 and 12 sweeps for a few
batches and lifting sizes: the slope is the cost of one sweep, and comparing
one codeword with 116 shows whether that cost is the latency of one CTA's row
chain or a shared resource. Prints nvcc's register and spill lines for the
new source and one JSON object. Run it from the repository root (it takes its inputs and its timer
from chip_smoke.py). It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

BG, Z, N_CW, N_ITER, NORM = 1, 384, 116, 6, 0.75


def _v1_decoder(source: str, dev):
    from isac_tpu_torch.ops.ldpc_layered import _row_plan
    from isac_tpu_torch.utils import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "libldpc_layered_v1.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).ldpc_layered_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code, plan = _row_plan(BG, Z)
    deg = [len(r) for r in plan]
    row_ptr, cols, shifts = (
        torch.as_tensor(np.asarray(a, np.int32), device=dev)
        for a in (np.concatenate([[0], np.cumsum(deg)]), [c for r in plan for _, c, _ in r],
                  [s for r in plan for _, _, s in r]))

    def decode(llr):
        out = torch.empty_like(llr)
        msg = torch.zeros((llr.shape[0], cols.shape[0], Z), dtype=torch.float32, device=dev)
        err = fn(llr.data_ptr(), out.data_ptr(), msg.data_ptr(), row_ptr.data_ptr(),
                 cols.data_ptr(), shifts.data_ptr(), llr.shape[0], code.n_rows, code.n_cols,
                 cols.shape[0], max(deg), Z, N_ITER, NORM,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"first-version kernel launch failed: cudaError {err}")
        return out

    return decode


def main(source: str) -> None:
    from chip_smoke import _noisy_llrs, _smi_line, _time_cuda
    from isac_tpu_torch.ops.ldpc_layered import decode_layered_cuda
    from isac_tpu_torch.utils import cuda_build
    from isac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    cuda_build.build("ldpc_layered")
    for ln in cuda_build.BUILD_LOG.get("ldpc_layered", "").splitlines():
        if "registers" in ln or "spill" in ln:
            print(ln.strip(), flush=True)
    old = _v1_decoder(source, dev)

    def new(x):
        return decode_layered_cuda(x, BG, Z, N_ITER, NORM)

    llrs = [x.view(N_CW, -1, Z) for x in _noisy_llrs(BG, Z, N_CW, 0.9, 1384, dev, n_sets=4)]
    a, b = old(llrs[0]), new(llrs[0])
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"posteriors differ, max |err| {float((a - b).abs().max())}")
    ms = {"old": [], "new": []}
    for name in ("old", "new", "new", "old", "old", "new", "new", "old"):
        ms[name].append(_time_cuda(old if name == "old" else new, llrs, 20))
    sweeps = {}
    for bg, z, n_cw in ((1, 384, 116), (1, 384, 1), (1, 384, 264), (2, 384, 116), (1, 64, 116)):
        xs = [x.view(n_cw, -1, z) for x in _noisy_llrs(bg, z, n_cw, 0.9, 5, dev, n_sets=4)]
        sweeps[f"BG{bg} Z={z} x{n_cw}"] = {
            n: _time_cuda(lambda x: decode_layered_cuda(x, bg, z, n, NORM), xs, 20)
            for n in (1, 6, 12)}
    print(json.dumps({"device": _smi_line(), "shape": [BG, Z, N_CW, N_ITER],
                      "posterior_bit_equal": True, "old_ms": ms["old"], "new_ms": ms["new"],
                      "new_ms_by_sweeps": sweeps}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
