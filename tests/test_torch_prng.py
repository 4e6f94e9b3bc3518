"""The port's threefry draws (isac_tpu_torch/utils/prng.py) against JAX's.

Keys come from numpy's SeedSequence as the engine makes them. Threefry words,
split keys, random bits and the uniforms built from them are integer or
bit-exact functions and must be equal. Normals go through erf_inv, whose
log1p differs from XLA's by an ulp on some inputs: they are held to rel 5e-7
(measured: at most 2.4e-7, about 2 ulps).

Also on the CPU: the scaled complex draw equals the post-pass's form, the
`impl` choice, the draws' counts, and the kernel's constants against the plain
version's. The kernel itself is held to the plain version on the card in
tests/test_torch_prng_card.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from isac_tpu_torch.utils import prng, tracing

torch.set_num_threads(1)

NORMAL_RTOL = 5e-7

KEYS = [np.random.SeedSequence(s).generate_state(2).astype(np.uint32)
        for s in ([0, 0, 7], [0, 13, 9], [3, 10**6, 0], [12345, 2, 1001])]
SHAPES = [(1,), (7,), (3, 5), (2, 2, 14, 37), (4, 1, 3, 2)]


def _jkey(key):
    return jnp.asarray(key)


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_threefry_block_exact(key):
    rng = np.random.default_rng(int(key[0]))
    x0 = rng.integers(0, 2**32, 1001, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2**32, 1001, dtype=np.uint64).astype(np.uint32)
    x0[:3], x1[:3] = [0, 0, 2**32 - 1], [0, 1, 2**32 - 1]
    f = jax.jit(lambda k0, k1, a, b: jprng.threefry2x32_p.bind(k0, k1, a, b))
    j0, j1 = f(jnp.uint32(key[0]), jnp.uint32(key[1]), jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = prng.threefry2x32(key, torch.as_tensor(x0.astype(np.int64)),
                               torch.as_tensor(x1.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_exact(key, num):
    np.testing.assert_array_equal(prng.split(key, num),
                                  np.asarray(jax.random.split(_jkey(key), num)))


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_exact(key, shape):
    jb = np.asarray(jax.random.bits(_jkey(key), shape, jnp.uint32)).astype(np.int64)
    tb = prng.random_bits(key, shape, "cpu")
    np.testing.assert_array_equal(tb.numpy(), jb)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    ju = np.asarray(jax.random.uniform(_jkey(key), shape, jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(prng.uniform_from_bits(tb).numpy(), ju)


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_close(key, shape):
    jn = np.asarray(jax.random.normal(_jkey(key), shape, jnp.float32))
    tn = prng.normal(key, shape, "cpu").numpy()
    assert tn.dtype == np.float32 and tn.shape == shape
    np.testing.assert_allclose(tn, jn, rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("key", KEYS[:2], ids=range(2))
def test_complex_normal_close(key):
    """The engine's AWGN expression, (normal(kr) + 1j*normal(ki)) * sqrt(0.5)."""
    shape = (3, 2, 14, 72)
    kr, ki = jax.random.split(_jkey(key))
    want = np.asarray((jax.random.normal(kr, shape, jnp.float32)
                       + 1j * jax.random.normal(ki, shape, jnp.float32)
                       ).astype(jnp.complex64) * np.float32(np.sqrt(0.5)))
    got = prng.complex_normal(key, shape, "cpu").numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got.real, want.real, rtol=NORMAL_RTOL, atol=0)
    np.testing.assert_allclose(got.imag, want.imag, rtol=NORMAL_RTOL, atol=0)


def test_chunked_draw_equals_whole(monkeypatch):
    """A draw made in chunks equals the same draw in one piece, across chunk
    boundaries that fall inside the last axis."""
    key, shape = KEYS[1], (5, 77)
    whole = prng.normal(key, shape, "cpu")
    bits = prng.random_bits(key, shape, "cpu")
    monkeypatch.setattr(prng, "CHUNK", 13)
    assert torch.equal(prng.normal(key, shape, "cpu"), whole)
    assert torch.equal(prng.random_bits(key, shape, "cpu"), bits)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
@pytest.mark.parametrize("draw", ["random_bits", "normal", "complex_normal"])
def test_no_device_means_the_card(draw):
    """device=None draws on the card, as every entry point of the port: without
    one it raises instead of drawing on the host."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(prng, draw)(KEYS[0], (4,))


def test_key_shape_checked():
    with pytest.raises(ValueError):
        prng.split(np.zeros(3, np.uint32))


# a post-pass sigma, sqrt(n0 / 2) in float32, with n0 the thermal noise of a
# 122.88 MHz sample rate and a 7 dB noise figure
POST_PASS_SIGMA = float(np.float32(np.sqrt(1.380649e-23 * 290.0 * 10**0.7 * 122.88e6 / 2.0)))


def _bits(z: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(z).view(torch.int32)


@pytest.mark.parametrize("key", KEYS[:2], ids=range(2))
@pytest.mark.parametrize("scale", [prng._SQRT_HALF, POST_PASS_SIGMA, 1.0],
                         ids=["sqrt_half", "post_pass_sigma", "one"])
def test_complex_normal_scale_is_the_post_pass_form(key, scale):
    """complex_normal(scale=s) is bit for bit the post-pass's former
    torch.complex(normal(kr) * s, normal(ki) * s)."""
    shape = (37, 4)
    kr, ki = prng.split(key)
    want = torch.complex(prng.normal(kr, shape, "cpu") * scale,
                         prng.normal(ki, shape, "cpu") * scale)
    got = prng.complex_normal(key, shape, "cpu", scale=scale)
    assert got.dtype == torch.complex64 and got.shape == shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("impl", ["cuda", "triton", ""])
def test_impl_checked(impl):
    """The kernel on the CPU raises, as does an unknown impl: no draw falls
    back to another implementation."""
    with pytest.raises(ValueError):
        prng.complex_normal(KEYS[0], (4,), "cpu", impl=impl)


def test_kernel_entry_needs_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        prng.complex_normal_cuda(KEYS[0], (4,), "cpu")


def test_normals_counted():
    """Every draw counts its real normals as prng.normals; on the CPU the
    kernel draws none, so prng.kernel_normals is never counted."""
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("draws"):
            prng.complex_normal(KEYS[0], (3, 5), "cpu")
            prng.complex_normal(KEYS[1], (7,), "cpu", scale=2.0, impl="torch")
            prng.normal(KEYS[2], (4,), "cpu")
        recs = tracing.records()
    finally:
        tracing.disable()
        tracing.reset()
    (rec,) = [r for r in recs if r.name == "draws"]
    assert rec.counts == {"prng.normals": 2 * 15 + 2 * 7 + 4}


def _hex_floats(text: str) -> list:
    return [float.fromhex(m) for m in re.findall(r"-?0x[0-9a-f]+(?:\.[0-9a-f]*)?p[-+]?\d+", text)]


def test_kernel_constants_are_the_plain_versions():
    """The kernel's float constants are the float32 values the plain
    version's Python scalars round to: the uniform's range, sqrt(2) and both
    erf_inv tables, in the order the polynomial takes them."""
    src = (Path(prng.__file__).parents[1] / "csrc" / "threefry_normal.cu").read_text()
    f32 = [float(np.float32(c)) for c in (prng._LO, prng._SPAN, prng._SQRT2)]
    for name, want in zip(("U_LO", "U_SPAN", "SQRT2"), f32):
        (line,) = [ln for ln in src.splitlines() if ln.startswith(f"#define {name} ")]
        value = _hex_floats(line) or [float(line.split()[-1].rstrip("f"))]
        assert value == [want], name
    body = src[src.index("float erf_inv("):src.index("float normal_of(")]
    lits = _hex_floats(body)
    assert lits[0::2] == [float(np.float32(c)) for c in prng._ERFINV_SMALL]
    assert lits[1::2] == [float(np.float32(c)) for c in prng._ERFINV_LARGE]
