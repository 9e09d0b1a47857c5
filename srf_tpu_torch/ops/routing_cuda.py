"""K1: the SDR forward as a hand-written CUDA kernel (``csrc/sdr_fwd.cu``).

Replaces the TPU kernel ``srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel``.
Its plain PyTorch version is ``ops/routing.py:sequential_routing``;
``route_layer`` sends CUDA tensors here and CPU tensors there. The library
is compiled with nvcc when the first CUDA tensor arrives (see
``cuda_build``), never at import.
"""

import ctypes
import functools

import torch

from srf_tpu_torch.ops import cuda_build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(cuda_build.build(["sdr_fwd"])["sdr_fwd"])
    lib.sdr_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.sdr_fwd.restype = ctypes.c_int
    lib.sdr_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sdr_fwd_smem_bytes.restype = ctypes.c_int
    lib.sdr_fwd_error_string.argtypes = [ctypes.c_int]
    lib.sdr_fwd_error_string.restype = ctypes.c_char_p
    return lib


def sequential_routing_cuda(u, wgt, bias, num_iter, mask_pad_capsule):
    """SDR forward on the card: same contract as ``sequential_routing``.

    u [B, T, in_n, in_d], wgt [in_n, out_n, out_d, in_d], bias
    [in_n, out_n, out_d], float32, contiguous, on one CUDA device ->
    [B, T, out_n, out_d]. Raises on anything the kernel does not take; it
    never falls back to the plain version. ``sequential_routing_cuda.launches``
    counts the kernel's launches.
    """
    if not u.is_cuda:
        raise ValueError(
            "sequential_routing_cuda takes CUDA tensors (got %s); the plain "
            "version is ops.routing.sequential_routing" % u.device
        )
    for name, x, ndim in (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)):
        if x.device != u.device:
            raise ValueError("%s is on %s, u on %s" % (name, x.device, u.device))
        if x.dtype != torch.float32:
            raise TypeError("%s must be float32, got %s" % (name, x.dtype))
        if x.dim() != ndim:
            raise ValueError("%s must be %d-D, got %s" % (name, ndim, tuple(x.shape)))
        if not x.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    if (wgt.shape[0], wgt.shape[3]) != (in_n, in_d) or tuple(bias.shape) != (
            in_n, out_n, out_d):
        raise ValueError(
            "shape mismatch: u %s, W %s, bias %s" % (
                tuple(u.shape), tuple(wgt.shape), tuple(bias.shape))
        )
    if num_iter < 1 or batch < 1 or seq_len < 1:
        raise ValueError(
            "need num_iter, B and T >= 1 (got %d, %d, %d)"
            % (num_iter, batch, seq_len)
        )
    lib = _lib()
    if lib.sdr_fwd_smem_bytes(in_n, in_d, out_n, out_d) < 0:
        raise ValueError(
            "capsule geometry (in_n, out_n, out_d, in_d) = (%d, %d, %d, %d) "
            "does not fit the SDR kernel's shared memory"
            % (in_n, out_n, out_d, in_d)
        )
    out = torch.empty((batch, seq_len, out_n, out_d), dtype=torch.float32,
                      device=u.device)
    with torch.cuda.device(u.device):
        err = lib.sdr_fwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), out.data_ptr(),
            batch, seq_len, in_n, in_d, out_n, out_d, num_iter,
            int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            "sdr_fwd kernel launch failed: %s"
            % lib.sdr_fwd_error_string(err).decode()
        )
    sequential_routing_cuda.launches += 1
    return out


sequential_routing_cuda.launches = 0
