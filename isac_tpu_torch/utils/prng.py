"""Counter-based random draws equal to JAX's default PRNG (threefry2x32).

The reference engine draws every noise term as ``jax.random.split(key)``
followed by two ``jax.random.normal`` calls, with keys made on the host
(``[2]`` uint32). The functions here compute the same draws with torch, on
whatever device they are asked to, so that the port's engine sees the same
noise as the reference:

- ``threefry2x32``: the 20-round Threefry-2x32 block function
  (jax/_src/prng.py ``_threefry2x32_lowering``);
- ``split``: keys of ``jax.random.split`` under the partitionable threefry
  setting (``_threefry_split_foldlike``: the block function of the key over
  the 64-bit counters 0..num-1, split into high and low words);
- ``random_bits``: ``jax.random.bits`` of 32-bit width, partitionable form
  (``_threefry_random_bits_partitionable``: counters are the flat element
  index as two 32-bit words, the result is the XOR of the two output words);
- ``normal``: ``jax.random.normal`` in float32 (``_normal_real``: a uniform
  in (nextafter(-1, 0), 1) from the top 23 bits, then sqrt(2) * erf_inv);
- ``complex_normal``: ``(normal(kr) + 1j*normal(ki)) * sqrt(0.5)`` for
  ``kr, ki = split(key)``, the engine's complex AWGN.

The threefry words, the split keys and the bits equal JAX's exactly. erf_inv
is the single-precision polynomial (M. Giles, "Approximating the erfinv
function") that XLA lowers ``erf_inv`` to, with ``w = -log1p(-x*x)``; torch's
``log1p`` differs from XLA's by an ulp on some inputs, so the normals agree
to about 2 ulps and are compared at a tolerance (tests/test_torch_prng.py).

Two implementations of a draw:

- the plain version (``random_bits``, ``normal`` and ``complex_normal`` with
  ``impl="torch"``): the unsigned 32-bit arithmetic is carried in int64
  tensors with an explicit mask after every addition and rotation, so
  wrap-around and logical shifts do not depend on how a backend treats signed
  overflow. Large draws are made in chunks of ``CHUNK`` elements, so the
  int64 temporaries stay at a few hundred MB whatever the size of the
  result. The CPU tests and the JAX comparison use it;
- ``complex_normal_cuda``: the hand-written kernel
  (csrc/threefry_normal.cu), one launch a complex draw in native uint32,
  bit-equal to the plain version on the card.

``complex_normal(..., impl=None)`` launches the kernel for a CUDA device and
takes the plain version for the CPU; ``impl="cuda"`` on the CPU raises. Every
draw counts its real normals as ``prng.normals`` and those the kernel drew as
``prng.kernel_normals`` (utils/tracing.py).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.utils import tracing
from isac_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
CHUNK = 1 << 22

# jax.random.uniform's range for normal draws: (nextafter(-1, 0), 1) in f32
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SPAN = float(np.float32(1.0) - np.float32(_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_SQRT_HALF = float(np.float32(np.sqrt(0.5)))
# erf_inv single-precision polynomial coefficients, highest order first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _key_words(key) -> tuple:
    k = np.asarray(key).astype(np.uint64).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {np.shape(key)}")
    return int(k[0]), int(k[1])


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under key (two uint32).

    x0, x1: int64 tensors, numpy int64 arrays or Python ints holding uint32
    values.
    Returns the two output words in the same form."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` of a raw key: [num, 2] uint32 on the
    host (keys stay host values; only draws go to a device). The block
    function runs on Python ints: a key is a few words, not an array."""
    return np.asarray([threefry2x32(key, 0, j) for j in range(num)], np.uint32).reshape(num, 2)


def _bits_chunk(key, start: int, stop: int, device) -> torch.Tensor:
    """32-bit random words of flat indices start..stop-1, as int64."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _M32)
    return y0 ^ y1


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2**32),
    on `device` (None = the card)."""
    dev = resolve_device(device)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, CHUNK):
        out[s: min(n, s + CHUNK)] = _bits_chunk(key, s, min(n, s + CHUNK), dev)
    return out.reshape(shape)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniform in (nextafter(-1, 0), 1) from 32-bit words, as
    jax.random.uniform makes it: the top 23 bits as the mantissa of a float
    in [1, 2), minus 1, scaled and shifted, clamped at the low end."""
    one = (bits >> 9) | 0x3F800000
    f = one.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * _SPAN + _LO, _LO)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Single-precision erf_inv (Giles' polynomial, XLA's form) for |x| < 1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, a, b) + p * w
    return p * x


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on `device` (None = the card)."""
    dev = resolve_device(device)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        out[s:e] = erf_inv(uniform_from_bits(_bits_chunk(key, s, e, dev))) * _SQRT2
    tracing.count("prng.normals", n)
    return out.reshape(shape)


# ------------------------------------------------------------- CUDA kernel

# The kernel's block, and the most blocks a launch takes per SM: one full
# wave of the card; a larger draw strides over it.
_THREADS = 256
_BLOCKS_PER_SM = 8
_WHAT = {"normal": 0, "bits": 1}


@lru_cache(maxsize=8)
def _max_blocks(device: torch.device) -> int:
    return _BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _library():
    from isac_tpu_torch.utils import cuda_build

    lib = cuda_build.load("threefry_normal")
    if lib.threefry_complex_normal.argtypes is None:
        lib.threefry_complex_normal.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_uint] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.threefry_complex_normal.restype = ctypes.c_int
        lib.threefry_normal_table.argtypes = [ctypes.c_void_p] * 3
        lib.threefry_normal_table.restype = ctypes.c_int
    return lib


def complex_normal_cuda(key, shape, device, scale=_SQRT_HALF, what="normal") -> torch.Tensor:
    """``complex_normal`` through the kernel, in one launch on the current
    stream of `device` (a CUDA device). Counts each launch in
    ``complex_normal_cuda.launches``.

    what: "normal" (the draw), or "bits" for the checks: the kernel's words
    of kr and ki, int64 [*shape, 2]. The uniforms and normals of every word
    are checked through ``normal_table_cuda``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"complex_normal_cuda needs a CUDA device, got {dev}")
    if what not in _WHAT:
        raise ValueError(f"what must be one of {sorted(_WHAT)}, got {what!r}")
    kr, ki = split(key)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = torch.empty(shape, dtype=torch.complex64, device=dev)
    if n:
        blocks = min(-(-n // _THREADS), _max_blocks(out.device))
        fn = _library().threefry_complex_normal
        with torch.cuda.device(out.device):
            err = fn(out.data_ptr(), n, int(kr[0]), int(kr[1]), int(ki[0]), int(ki[1]),
                     float(scale), _WHAT[what], blocks,
                     torch.cuda.current_stream(out.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"threefry_normal kernel launch failed: cudaError {err}")
        complex_normal_cuda.launches += 1
    if what == "bits":
        return torch.view_as_real(out).view(torch.int32).to(torch.int64) & _M32
    return out


complex_normal_cuda.launches = 0


def normal_table_cuda(device) -> tuple:
    """The kernel's uniform and unscaled normal of each of the 2^23 words
    that differ in their top 23 bits (word j << 9 at index j): every value a
    draw can take, float32 [2^23] each, for the checks."""
    dev = torch.device(device)
    uniform = torch.empty(1 << 23, dtype=torch.float32, device=dev)
    nrm = torch.empty_like(uniform)
    with torch.cuda.device(uniform.device):
        err = _library().threefry_normal_table(
            uniform.data_ptr(), nrm.data_ptr(),
            torch.cuda.current_stream(uniform.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_normal_table launch failed: cudaError {err}")
    return uniform, nrm


# ---------------------------------------------------------------- public API


def complex_normal(key, shape, device=None, scale=_SQRT_HALF, impl=None) -> torch.Tensor:
    """Complex64 AWGN of `shape`: the reference engine's
    ``(normal(kr) + 1j*normal(ki)) * scale`` with ``kr, ki = split(key)``
    (``scale`` sqrt(0.5) for unit variance), each part rounded as
    ``normal(k) * scale``, on `device` (None = the card).

    impl: None (the kernel for a CUDA device, the plain version for the CPU)
    | 'torch' | 'cuda' (raises on the CPU)."""
    if impl not in (None, "torch", "cuda"):
        raise ValueError(f"impl must be None, 'torch' or 'cuda', got {impl!r}")
    dev = resolve_device(device)
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "torch"
    if impl == "cuda":
        out = complex_normal_cuda(key, shape, dev, scale)
        tracing.count("prng.normals", 2 * out.numel())
        tracing.count("prng.kernel_normals", 2 * out.numel())
        return out
    kr, ki = split(key)
    return torch.complex(normal(kr, shape, dev).mul_(scale), normal(ki, shape, dev).mul_(scale))
