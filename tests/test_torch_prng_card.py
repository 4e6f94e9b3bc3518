"""The threefry kernel (csrc/threefry_normal.cu, `prng.complex_normal_cuda`)
against the plain int64 version of utils/prng.py, both on the card.

The words must be equal, and so must the uniforms and the normals, bit for
bit: every one of the 2^23 values a uniform and a normal can take (the
table of the top 23 bits), and the complex draws at the engine's shapes
(one element, 1000, the DL grid [5, 2, 14, 3276], the UL grid
[5, 16, 14, 3276], the post-pass's [1228800, 16], one draw past the plain
version's chunk of 2^22) with scale sqrt(1/2) and a post-pass sigma. Each
draw is one launch.

Every test here needs the card (marker ``card``); this file imports no JAX,
so run it there with
``python -m pytest --noconftest tests/test_torch_prng_card.py -m card -s``.
"""

import numpy as np
import pytest
import torch

from isac_tpu_torch.utils import prng, tracing

KEYS = [np.random.SeedSequence(s).generate_state(2).astype(np.uint32)
        for s in ([0, 0, 7], [3, 10**6, 0], [12345, 2, 1001])]
KEYS.append(np.array([0xFFFFFFFF, 0xFFFFFFFF], np.uint32))
SHAPES = [(1,), (1000,), (5, 2, 14, 3276), (5, 16, 14, 3276), (1228800, 16),
          ((1 << 22) + 5,)]
POST_PASS_SIGMA = float(np.float32(np.sqrt(1.380649e-23 * 290.0 * 10**0.7 * 122.88e6 / 2.0)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return (torch.view_as_real(x) if x.is_complex() else x).view(torch.int32)


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_card_words_exact(card, shape):
    """The kernel's threefry words of kr and ki; the uniform and normal of
    every word are held by the table test below."""
    key = KEYS[len(shape) % len(KEYS)]
    kr, ki = prng.split(key)
    words = prng.complex_normal_cuda(key, shape, card, what="bits")
    for part, k in ((0, kr), (1, ki)):
        assert torch.equal(words[..., part], prng.random_bits(k, shape, card))


@pytest.mark.card
def test_card_every_normal_value_equal(card):
    """All 2^23 uniforms and their normals, kernel against plain version."""
    uniform, normal = prng.normal_table_cuda(card)
    bits = torch.arange(1 << 23, dtype=torch.int64, device=card) << 9
    u = prng.uniform_from_bits(bits)
    assert torch.equal(uniform.view(torch.int32), u.view(torch.int32))
    plain = prng.erf_inv(u) * prng._SQRT2
    differ = normal.view(torch.int32) != plain.view(torch.int32)
    ulps = (normal.view(torch.int32).to(torch.int64) - plain.view(torch.int32).to(torch.int64)).abs()
    print(f"normals differing: {int(differ.sum())} of {1 << 23}, largest gap {int(ulps.max())} ulp")
    assert not differ.any()


@pytest.mark.card
@pytest.mark.parametrize("scale", [prng._SQRT_HALF, POST_PASS_SIGMA], ids=["sqrt_half", "sigma"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_card_complex_normal_bit_equal(card, shape, scale):
    key = KEYS[(len(shape) + 1) % len(KEYS)]
    got = prng.complex_normal(key, shape, card, scale=scale, impl="cuda")
    want = prng.complex_normal(key, shape, card, scale=scale, impl="torch")
    assert got.shape == shape and got.dtype == torch.complex64
    assert torch.equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.card
def test_card_one_launch_per_draw(card):
    """The card's default is the kernel: one launch a draw, whatever the
    size, and every normal counted as the kernel's."""
    tracing.reset()
    tracing.enable()
    try:
        before = prng.complex_normal_cuda.launches
        with tracing.span("draws"):
            for shape in SHAPES[:4]:
                prng.complex_normal(KEYS[0], shape, card)
        recs = tracing.records()
    finally:
        tracing.disable()
        tracing.reset()
    assert prng.complex_normal_cuda.launches == before + 4
    n = 2 * sum(int(np.prod(s)) for s in SHAPES[:4])
    (rec,) = [r for r in recs if r.name == "draws"]
    assert rec.counts.get("prng.normals") == n
    assert rec.counts.get("prng.kernel_normals") == n
