"""K5's plain version (``srf_tpu_torch/ops/dropout.py``) and its autograd
function, on the CPU.

The TPU kernel's hardware-PRNG stream cannot be reproduced, and the JAX
package's own CPU path (``srf_tpu/ops/dropout_pallas.py:127-131``) is a
different XLA bernoulli stream, so the port defines its own (Philox4x32-10
over the logical element index) and is held here to the same *contract*
as ``tests/test_dropout_pallas.py:27-66``, not to JAX's values: the keep
fraction and scale, determinism per seed, a backward whose mask is the
forward's, rate 0 as the identity, and sizes across the old 1024-lane
boundary. The Philox itself is held to Random123's known-answer vectors.
The CUDA kernel (``csrc/fused_dropout.cu``) runs only on the card, where
``chip_smoke.py`` holds it to this plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from srf_tpu_torch.ops.dropout import (dropout_constants, fused_dropout,
                                       fused_dropout_plain, philox4x32_10,
                                       random_bits, site_seed)
from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda

torch.set_num_threads(1)

SEED = 1234


@pytest.fixture(scope="module")
def x():
    return torch.from_numpy(
        np.random.RandomState(0).randn(4, 37, 50).astype(np.float32))


@pytest.mark.parametrize("word,key,want", [
    (0, 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (0xFFFFFFFF, 0xFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(word, key, want):
    counter = [torch.full((1,), word, dtype=torch.int64)] * 4
    got = philox4x32_10(*counter, key, key)
    assert tuple(int(w) for w in got) == want


def test_stream_layout():
    """Element i takes word i % 4 of Philox((i // 4, 0, 0, 0), seed)."""
    seed = 0x0123456789ABCDEF
    bits = random_bits(10, seed)
    for g in range(3):
        c = torch.tensor([g], dtype=torch.int64)
        zero = torch.zeros_like(c)
        words = philox4x32_10(c, zero, zero, zero, seed & 0xFFFFFFFF,
                              seed >> 32)
        for j in range(4):
            if 4 * g + j < 10:
                assert int(bits[4 * g + j]) == int(words[j])


def test_keep_fraction_and_scale(x):
    y = fused_dropout(x, SEED, 0.2)
    assert abs((y != 0).float().mean().item() - 0.8) < 0.03
    ratio = torch.where(y != 0, y / x, torch.tensor(1.25))
    np.testing.assert_allclose(ratio.numpy(), 1.25, atol=1e-5)
    assert dropout_constants(0.2) == (858993459, 1.25)


def test_deterministic_and_seed_dependent(x):
    a = fused_dropout(x, SEED, 0.2)
    assert torch.equal(a, fused_dropout(x, SEED, 0.2))
    assert not torch.equal(a != 0, fused_dropout(x, 99, 0.2) != 0)


def test_backward_regenerates_identical_mask(x):
    leaf = x.clone().requires_grad_()
    y = fused_dropout(leaf, SEED, 0.2)
    (3.0 * y).sum().backward()
    assert torch.equal(y != 0, leaf.grad != 0)
    np.testing.assert_allclose(
        torch.where(leaf.grad != 0, leaf.grad, torch.tensor(3.75)).numpy(),
        3.75, atol=1e-5)


def test_rate_zero_identity(x):
    leaf = x.clone().requires_grad_()
    y = fused_dropout(leaf, SEED, 0.0)
    assert y is leaf
    y.sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(x))


@pytest.mark.parametrize("n", [1023, 1024, 1025, 5000])
def test_odd_sizes(n):
    y = fused_dropout(torch.ones(n), SEED, 0.5)
    assert y.shape == (n,)
    assert set(y.unique().tolist()) <= {0.0, 2.0}


def test_mask_follows_the_logical_index():
    """A channels_last input, and a cotangent in another layout than the
    input, get the mask of the same logical elements."""
    base = torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(1))
    last = base.to(memory_format=torch.channels_last)
    assert not last.is_contiguous()
    want = fused_dropout(base, SEED, 0.3)
    assert torch.equal(fused_dropout(last, SEED, 0.3), want)
    leaf = last.clone().requires_grad_()
    fused_dropout(leaf, SEED, 0.3).backward(
        torch.ones_like(base).to(memory_format=torch.channels_last))
    assert torch.equal(leaf.grad != 0, want != 0)


def test_plain_version_takes_any_float_dtype():
    x = torch.randn(300, dtype=torch.float64)
    assert torch.equal(fused_dropout_plain(x, 5, 0.4) != 0,
                       fused_dropout_plain(x.float(), 5, 0.4) != 0)


def test_kernel_wrapper_refuses_a_cpu_tensor(x):
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_dropout_cuda(x, SEED, 0.2)


def test_site_seeds_differ():
    seeds = {site_seed(base, i) for base in (0, 1, 1234) for i in range(25)}
    assert len(seeds) == 75 and all(0 <= s < 1 << 64 for s in seeds)
