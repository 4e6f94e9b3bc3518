"""The port's threefry draws (isac_tpu_torch/utils/prng.py) against JAX's.

Keys come from numpy's SeedSequence as the engine makes them. Threefry words,
split keys, random bits and the uniforms built from them are integer or
bit-exact functions and must be equal. Normals go through erf_inv, whose
log1p differs from XLA's by an ulp on some inputs: they are held to rel 5e-7
(measured: at most 2.4e-7, about 2 ulps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from isac_tpu_torch.utils import prng

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
