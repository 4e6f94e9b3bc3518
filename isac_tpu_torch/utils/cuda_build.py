"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``isac_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``build/kernels/`` at the repository root (listed
in .gitignore) for sm_90a with ``--fmad=false`` (the kernels are held
bit-equal to their plain PyTorch versions, so no multiply-add may be
contracted into an FMA). The library file name carries a hash of the source
and the flags, so an edited source is rebuilt and never mixed up with an old
build. Nothing here runs at import time: this module is imported on hosts
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}
BUILD_LOG: dict = {}  # name -> nvcc's stderr (ptxas -v) of builds made in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a build of this exact source exists.
    Raises with nvcc's output if the compiler refuses it."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = proc.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
