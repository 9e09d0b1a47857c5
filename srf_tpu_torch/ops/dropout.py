"""K5's plain version: one-pass inverted dropout keyed by a host seed
(counterpart of ``srf_tpu/ops/dropout_pallas.py``).

The contract is the JAX one (``dropout_pallas.py:58-63,112-131``): an
element is kept, and multiplied by ``scale = 1 / (1 - rate)`` (as a
float32), where its uniform uint32 is ``>= threshold = min(round(rate *
2**32), 2**32 - 1)``, and set to 0 elsewhere; ``rate <= 0`` is the
identity; the backward regenerates the same mask from the seed and applies
it, with the scale, to the cotangent, so nothing but the seed is saved.

The TPU kernel's hardware-PRNG stream cannot be reproduced (nor can the
JAX CPU path's, another XLA bernoulli stream), so the port fixes its own,
independent of any launch layout: Philox4x32-10 (Salmon et al., SC'11,
the Random123 constants) with key ``(seed & 0xffffffff, seed >> 32)`` and
counter ``(g & 0xffffffff, g >> 32, 0, 0)`` for ``g = i // 4``; element
``i``, the row-major logical index into ``x``, takes word ``i % 4``. The
CUDA kernel (``csrc/fused_dropout.cu``) computes the same bits, so the two
agree bit for bit. Here the Philox runs on int64 tensors: a 32 x 32-bit
product does not fit a signed int64, so the multiplier is split into
16-bit halves.

``fused_dropout`` is what the models call: it sends a CUDA tensor to the
kernel and a CPU tensor to :func:`fused_dropout_plain`, both through
``ops.dropout_cuda.FusedDropoutFunction``.
"""

import torch

from srf_tpu_torch.ops.dropout_cuda import FusedDropoutFunction

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
# Philox4x32 round multipliers and key increments (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def dropout_constants(rate):
    """(threshold, scale) of ``rate``, as ``dropout_pallas.py:61-62``
    computes them; ``scale`` is rounded to float32, the type it is
    multiplied in."""
    threshold = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()
    return threshold, scale


def _mulhilo(a, multiplier):
    """(high, low) 32-bit words of ``a * multiplier``, ``a`` an int64
    tensor of uint32 values: exact, since each partial product stays below
    2**49."""
    m_hi, m_lo = multiplier >> 16, multiplier & 0xFFFF
    p_hi = a * m_hi
    low = ((p_hi & 0xFFFF) << 16) + a * m_lo
    return (p_hi >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values (the key words
    may be Python ints): returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def random_bits(numel, seed, device=None):
    """The stream's first ``numel`` uint32 words under ``seed``, as int64."""
    groups = -(-numel // 4)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _MASK32, g >> 32, zero, zero,
                          seed & _MASK32, (seed >> 32) & _MASK32)
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def fused_dropout_plain(x, seed, rate):
    """K5's function in plain PyTorch, on any device and memory layout:
    the mask follows ``x``'s logical (row-major) index. In x's dtype: for
    bf16 (the bf16 variant's plain version) ``x * scale`` is taken in
    float32 and rounded once."""
    threshold, scale = dropout_constants(rate)
    bits = random_bits(x.numel(), seed, x.device).reshape(x.shape)
    return torch.where(bits >= threshold, x * scale, torch.zeros_like(x))


def fused_dropout(x, seed, rate):
    """Inverted dropout of ``x`` at ``rate`` under the host integer
    ``seed`` (0 <= seed < 2**64): K5 on a CUDA tensor, the plain version on
    a CPU tensor, each with its backward regenerating the mask. ``rate <=
    0`` returns ``x`` and launches nothing."""
    if rate <= 0.0:
        return x
    return FusedDropoutFunction.apply(x, seed, rate)


def site_seed(base, index):
    """The seed of dropout site ``index`` of a forward whose seed is
    ``base`` (the step's generator seed): splitmix64 of the pair, so
    neighbouring sites and steps get unrelated Philox keys."""
    z = (base + (index + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)
