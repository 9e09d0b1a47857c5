"""K5: the fused dropout as a hand-written CUDA kernel
(``csrc/fused_dropout.cu``), and ``FusedDropoutFunction``, the autograd
function whose backward regenerates the mask.

K5 replaces the TPU kernel ``srf_tpu/ops/dropout_pallas.py:_mask_kernel``,
which runs in its input's dtype: float32 tensors go to K5, bf16 tensors
(``--tpu-bf16``) to its bf16 variant (``fused_dropout_bf16`` in the same
source), any other dtype raises. Its plain PyTorch version is
``ops/dropout.py:fused_dropout_plain``, which defines the random stream
for both; ``FusedDropoutFunction`` sends CUDA tensors to the kernel and CPU
tensors to the plain version. The library is compiled
with nvcc when the first CUDA tensor arrives (see ``cuda_build``), never at
import.
"""

import ctypes
import functools

import torch

from srf_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(cuda_build.build(["fused_dropout"])["fused_dropout"])
    for fn in (lib.fused_dropout, lib.fused_dropout_bf16):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fused_dropout_error_string.argtypes = [ctypes.c_int]
    lib.fused_dropout_error_string.restype = ctypes.c_char_p
    return lib


def fused_dropout_cuda(x, seed, rate):
    """Dropout of ``x`` on the card (K5): the contract of
    ``ops.dropout.fused_dropout_plain``, bit for bit.

    ``x`` float32 or bf16 (the bf16 variant: the same bits, ``x * scale``
    rounded once), contiguous, on a CUDA device; ``seed`` a host integer in
    [0, 2**64); 0 < rate < 1. Returns a new tensor. Raises on anything the
    kernel does not take and on a failed launch; it never falls back to
    the plain version. ``fused_dropout_cuda.launches`` counts K5's launches
    and ``fused_dropout_cuda.launches_bf16`` its bf16 variant's.
    """
    if not x.is_cuda:
        raise ValueError("fused_dropout_cuda takes CUDA tensors (got %s); "
                         "the plain version is ops.dropout.fused_dropout_plain"
                         % x.device)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("x must be float32 or bfloat16, got %s" % x.dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")
    if not 0.0 < rate < 1.0:
        raise ValueError("need 0 < rate < 1 (got %r)" % rate)
    if not 0 <= seed < 1 << 64:
        raise ValueError("seed must be in [0, 2**64) (got %r)" % seed)
    threshold, scale = _plain().dropout_constants(rate)
    lib = _lib()
    out = torch.empty_like(x)
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        err = (lib.fused_dropout_bf16 if bf16 else lib.fused_dropout)(
            x.data_ptr(), out.data_ptr(), x.numel(), seed, threshold, scale,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("fused_dropout kernel launch failed: %s"
                           % lib.fused_dropout_error_string(err).decode())
    if bf16:
        fused_dropout_cuda.launches_bf16 += 1
    else:
        fused_dropout_cuda.launches += 1
    return out


fused_dropout_cuda.launches = 0
fused_dropout_cuda.launches_bf16 = 0


class FusedDropoutFunction(torch.autograd.Function):
    """K5 with its mask-regenerating backward, the port of the custom VJP
    ``srf_tpu/ops/dropout_pallas.py:_pallas_dropout``.

    forward: K5 on a CUDA tensor, ``fused_dropout_plain`` on a CPU tensor;
    saves no tensor, only the seed and the rate (the JAX residual is the
    seed alone). backward: the same function with the same seed on the
    cotangent. Both make their input row-major first, so an input and a
    cotangent in other memory layouts (``channels_last``) get the mask of
    the same logical elements.
    """

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return _dispatch(x, seed, rate)

    @staticmethod
    def backward(ctx, grad):
        return _dispatch(grad, ctx.seed, ctx.rate), None, None


def _dispatch(x, seed, rate):
    x = x.contiguous()
    if x.is_cuda:
        return fused_dropout_cuda(x, seed, rate)
    return _plain().fused_dropout_plain(x, seed, rate)


def _plain():
    # ops.dropout imports this module for FusedDropoutFunction; the plain
    # version is looked up at call time so either may be imported first
    from srf_tpu_torch.ops import dropout

    return dropout
