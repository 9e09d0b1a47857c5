"""K1 and K2: the SDR forward and its fused backward as hand-written CUDA
kernels (``csrc/sdr_fwd.cu``, ``csrc/sdr_bwd.cu``), and ``SDRFunction``,
the autograd function that joins them.

K1 replaces the TPU kernel ``srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel``
and K2 ``_sdr_bwd_kernel``. Their plain PyTorch versions are
``ops/routing.py:sequential_routing`` and ``sequential_routing_bwd``;
``SDRFunction`` sends CUDA tensors to the kernels and CPU tensors to the
plain versions. The libraries are compiled with nvcc when the first CUDA
tensor arrives (see ``cuda_build``), never at import.
"""

import ctypes
import functools

import torch

from srf_tpu_torch.ops import cuda_build

_VOID_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib(name):
    lib = ctypes.CDLL(cuda_build.build([name])[name])
    if name == "sdr_fwd":
        lib.sdr_fwd.argtypes = [_VOID_P] * 4 + [ctypes.c_int] * 8 + [_VOID_P]
    else:
        lib.sdr_bwd.argtypes = [_VOID_P] * 9 + [ctypes.c_int] * 7 + [_VOID_P]
    getattr(lib, name).restype = ctypes.c_int
    smem_bytes = getattr(lib, name + "_smem_bytes")
    smem_bytes.argtypes = [ctypes.c_int] * 4
    smem_bytes.restype = ctypes.c_int
    error_string = getattr(lib, name + "_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn_name, u, tensors):
    """Device, dtype, rank and contiguity checks shared by both wrappers;
    ``tensors`` is ((name, tensor, ndim), ...)."""
    if not u.is_cuda:
        raise ValueError(
            "%s takes CUDA tensors (got %s); the plain version is "
            "ops.routing.%s" % (fn_name, u.device, fn_name[:-len("_cuda")])
        )
    for name, x, ndim in tensors:
        if x.device != u.device:
            raise ValueError("%s is on %s, u on %s" % (name, x.device, u.device))
        if x.dtype != torch.float32:
            raise TypeError("%s must be float32, got %s" % (name, x.dtype))
        if x.dim() != ndim:
            raise ValueError("%s must be %d-D, got %s" % (name, ndim, tuple(x.shape)))
        if not x.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def _check_geometry(lib, name, u, wgt, bias):
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    if (wgt.shape[0], wgt.shape[3]) != (in_n, in_d) or tuple(bias.shape) != (
            in_n, out_n, out_d):
        raise ValueError(
            "shape mismatch: u %s, W %s, bias %s" % (
                tuple(u.shape), tuple(wgt.shape), tuple(bias.shape))
        )
    if batch < 1 or seq_len < 1:
        raise ValueError("need B and T >= 1 (got %d, %d)" % (batch, seq_len))
    if getattr(lib, name + "_smem_bytes")(in_n, in_d, out_n, out_d) < 0:
        raise ValueError(
            "capsule geometry (in_n, out_n, out_d, in_d) = (%d, %d, %d, %d) "
            "does not fit the %s kernel's shared memory"
            % (in_n, out_n, out_d, in_d, name)
        )


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError(
            "%s kernel launch failed: %s"
            % (name, getattr(lib, name + "_error_string")(err).decode())
        )


def sequential_routing_cuda(u, wgt, bias, num_iter, mask_pad_capsule):
    """SDR forward on the card (K1): same contract as ``sequential_routing``.

    u [B, T, in_n, in_d], wgt [in_n, out_n, out_d, in_d], bias
    [in_n, out_n, out_d], float32, contiguous, on one CUDA device ->
    [B, T, out_n, out_d]. Raises on anything the kernel does not take; it
    never falls back to the plain version. ``sequential_routing_cuda.launches``
    counts the kernel's launches.
    """
    _check_inputs("sequential_routing_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)))
    if num_iter < 1:
        raise ValueError("need num_iter >= 1 (got %d)" % num_iter)
    lib = _lib("sdr_fwd")
    _check_geometry(lib, "sdr_fwd", u, wgt, bias)
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    out = torch.empty((batch, seq_len, out_n, out_d), dtype=torch.float32,
                      device=u.device)
    with torch.cuda.device(u.device):
        err = lib.sdr_fwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), out.data_ptr(),
            batch, seq_len, in_n, in_d, out_n, out_d, num_iter,
            int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_fwd", err)
    sequential_routing_cuda.launches += 1
    return out


sequential_routing_cuda.launches = 0


def sequential_routing_bwd_cuda(u, wgt, bias, vs, dvs, mask_pad_capsule):
    """The fused SDR backward on the card (K2), one routing iteration: same
    contract as ``sequential_routing_bwd``.

    u [B, T, in_n, in_d], wgt, bias, the forward's output vs and its
    cotangent dvs [B, T, out_n, out_d], float32, contiguous, on one CUDA
    device -> (du, dW, db). Allocates the kernel's scratch, the prediction
    vectors' cotangents [B, T, in_n, out_n * out_d]. Raises on anything the
    kernel does not take; never falls back to the plain version.
    ``sequential_routing_bwd_cuda.launches`` counts its kernel launches:
    two per call, the reverse-time kernel and the weight-gradient kernel.
    """
    _check_inputs("sequential_routing_bwd_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3),
                   ("vs", vs, 4), ("dvs", dvs, 4)))
    lib = _lib("sdr_bwd")
    _check_geometry(lib, "sdr_bwd", u, wgt, bias)
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    for name, x in (("vs", vs), ("dvs", dvs)):
        if tuple(x.shape) != (batch, seq_len, out_n, out_d):
            raise ValueError("%s must be %s, got %s" % (
                name, (batch, seq_len, out_n, out_d), tuple(x.shape)))
    du = torch.empty_like(u)
    dwgt = torch.empty_like(wgt)
    dbias = torch.empty_like(bias)
    du_hat = torch.empty((batch, seq_len, in_n, out_n * out_d),
                         dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.sdr_bwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), vs.data_ptr(),
            dvs.data_ptr(), du_hat.data_ptr(), du.data_ptr(),
            dwgt.data_ptr(), dbias.data_ptr(),
            batch, seq_len, in_n, in_d, out_n, out_d,
            int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_bwd", err)
    sequential_routing_bwd_cuda.launches += 2  # sdr_bwd_step, sdr_bwd_wgrad
    return du, dwgt, dbias


sequential_routing_bwd_cuda.launches = 0


class SDRFunction(torch.autograd.Function):
    """SDR with its fused backward, the port of the custom VJP
    ``srf_tpu/ops/routing_pallas.py:sequential_routing_pallas``.

    forward: K1 on a CUDA tensor, the plain ``sequential_routing`` on a CPU
    tensor; saves u, W, bias and the output, the JAX ``_fwd``'s residuals.
    backward: with one routing iteration K2 on CUDA and the plain
    ``sequential_routing_bwd`` on the CPU; with more, autograd through the
    plain loop recomputed from the saved inputs (the JAX ``_bwd`` does the
    same), counted in ``SDRFunction.plain_backwards``. Only ``num_iter``
    chooses; nothing falls back on failure.
    """

    plain_backwards = 0

    @staticmethod
    def forward(ctx, u, wgt, bias, num_iter, mask_pad_capsule):
        if u.is_cuda:
            out = sequential_routing_cuda(u, wgt, bias, num_iter,
                                          mask_pad_capsule)
        else:
            out = _plain().sequential_routing(u, wgt, bias, num_iter,
                                              mask_pad_capsule)
        ctx.save_for_backward(u, wgt, bias, out)
        ctx.num_iter = num_iter
        ctx.mask_pad_capsule = mask_pad_capsule
        return out

    @staticmethod
    def backward(ctx, dout):
        u, wgt, bias, out = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.num_iter == 1:
            bwd = (sequential_routing_bwd_cuda if u.is_cuda
                   else _plain().sequential_routing_bwd)
            du, dwgt, dbias = bwd(u, wgt, bias, out, dout,
                                  ctx.mask_pad_capsule)
            return du, dwgt, dbias, None, None
        SDRFunction.plain_backwards += 1
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (u, wgt, bias)]
            recomputed = _plain().sequential_routing(
                *inputs, ctx.num_iter, ctx.mask_pad_capsule)
            du, dwgt, dbias = torch.autograd.grad(recomputed, inputs, dout)
        return du, dwgt, dbias, None, None


def _plain():
    # ops.routing imports this module for SDRFunction; the plain versions
    # are looked up at call time so that either module may be imported first
    from srf_tpu_torch.ops import routing

    return routing
