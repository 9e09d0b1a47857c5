"""The SDR kernels: K1 and K2, the SDR forward and its fused backward
(``csrc/sdr_fwd.cu``, ``csrc/sdr_bwd.cu``, both built on the prediction
kernel and the streaming recurrence of ``csrc/sdr_stream.cuh``), joined by
``SDRFunction``; K3 and K4, their cluster-scan counterparts
(``csrc/sdr_scan_fwd.cu``, ``csrc/sdr_scan_bwd.cu``, both built on
``csrc/sdr_cluster.cuh``: a thread-block cluster per batch tile, W's slice
in shared memory, sums across the cluster through distributed shared
memory), joined by ``SDRScanFunction`` and applied by
``sequential_routing_scan``. Streaming's forward-only SDR, with an initial
carry and a per-step mask, is K1 through ``sequential_routing_stream``.
The scan kernels are cluster launches (``cudaLaunchKernelEx``, up to 16
CTAs a cluster, a non-portable size, sm_90a); a refused launch raises,
with no retry and no fallback.

K1 replaces the TPU kernel ``srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel``,
K2 ``_sdr_bwd_kernel``, K3 ``_sdr_v6_fwd_kernel`` and K4
``_sdr_v6_bwd_kernel``. All four compute one function, whose plain PyTorch
versions are ``ops/routing.py:sequential_routing`` and
``sequential_routing_bwd``; the autograd functions send CUDA tensors to the
kernels and CPU tensors to the plain versions. The libraries are compiled
with nvcc when the first CUDA tensor arrives (see ``cuda_build``), never at
import.
"""

import ctypes
import functools

import torch

from srf_tpu_torch.ops import cuda_build

_VOID_P = ctypes.c_void_p


# argtypes of each library's launch function, and the int arguments of its
# <name>_smem_bytes: the capsule geometry (in_n, in_d, out_n, out_d), and for
# the scan kernels the batch, T and time block around it
_PLAN_ARGS = {"sdr_fwd": 4, "sdr_bwd": 4, "sdr_scan_fwd": 7, "sdr_scan_bwd": 7}
_LAUNCH_ARGTYPES = {
    "sdr_fwd": [_VOID_P] * 7 + [ctypes.c_int] * 8 + [_VOID_P],
    "sdr_bwd": [_VOID_P] * 10 + [ctypes.c_int] * 7 + [_VOID_P],
    "sdr_scan_fwd": [_VOID_P] * 5 + [ctypes.c_int] * 9 + [_VOID_P],
    "sdr_scan_bwd": [_VOID_P] * 9 + [ctypes.c_int] * 8 + [_VOID_P],
}


@functools.lru_cache(maxsize=None)
def _lib(name):
    lib = ctypes.CDLL(cuda_build.build([name])[name])
    getattr(lib, name).argtypes = _LAUNCH_ARGTYPES[name]
    getattr(lib, name).restype = ctypes.c_int
    fn = getattr(lib, name + "_smem_bytes")
    fn.argtypes = [ctypes.c_int] * _PLAN_ARGS[name]
    fn.restype = ctypes.c_int
    if name.startswith("sdr_scan"):
        fn = getattr(lib, name + "_plan")
        fn.argtypes = [ctypes.c_int] * _PLAN_ARGS[name] + [_VOID_P]
        fn.restype = ctypes.c_int
    scratch_args = {"sdr_fwd": 6, "sdr_bwd": 6, "sdr_scan_fwd": 7,
                    "sdr_scan_bwd": 7}
    if name in scratch_args:
        fn = getattr(lib, name + "_scratch_floats")
        fn.argtypes = [ctypes.c_int] * scratch_args[name]
        fn.restype = ctypes.c_longlong
    error_string = getattr(lib, name + "_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(fn_name, u, tensors):
    """Device, dtype, rank and contiguity checks shared by the wrappers;
    ``tensors`` is ((name, tensor, ndim), ...)."""
    if not u.is_cuda:
        raise ValueError(
            "%s takes CUDA tensors (got %s); the plain version is "
            "ops.routing.%s" % (fn_name, u.device,
                                fn_name[:-len("_cuda")].replace("_scan", ""))
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


def _check_geometry(lib, name, u, wgt, bias, time_block=None):
    """Shapes agree, B and T are >= 1, and the kernel's shared memory holds
    the geometry (and, for the scan kernels, ``time_block`` steps of u)."""
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
    plan = (in_n, in_d, out_n, out_d)
    if time_block is not None:
        plan = (batch, seq_len, *plan, time_block)
    if getattr(lib, name + "_smem_bytes")(*plan) < 0:
        raise ValueError(
            "capsule geometry (in_n, out_n, out_d, in_d) = (%d, %d, %d, %d)%s "
            "does not fit the %s kernel's shared memory"
            % (in_n, out_n, out_d, in_d,
               "" if time_block is None else " with time_block %d" % time_block,
               name)
        )


def _check_time_block(time_block):
    if time_block < 1:
        raise ValueError("need time_block >= 1 (got %d)" % time_block)


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError(
            "%s kernel launch failed: %s"
            % (name, getattr(lib, name + "_error_string")(err).decode())
        )


def sequential_routing_cuda(u, wgt, bias, num_iter, mask_pad_capsule,
                            v_init=None, step_valid=None):
    """SDR forward on the card (K1): same contract as ``sequential_routing``.

    u [B, T, in_n, in_d], wgt [in_n, out_n, out_d, in_d], bias
    [in_n, out_n, out_d], float32, contiguous, on one CUDA device ->
    [B, T, out_n, out_d]. ``v_init`` [B, out_n, out_d] float32 (the carry
    before step 0; zeros if None) and ``step_valid`` [B, T] bool (an
    invalid step emits zeros and leaves a zero carry; every step valid
    if None), contiguous, on u's device. Allocates the kernels' scratch:
    the prediction vectors u_hat ([B, T, in_n, out_n * out_d rounded up to
    a multiple of 4]) and, for geometries whose partial sums do not fit in
    shared memory, the recurrence's per-warp sums. Raises on anything the
    kernels do not take; it never falls back to the plain version.
    ``sequential_routing_cuda.launches`` counts its kernel launches: two
    per call, the prediction kernel and the recurrence.
    """
    _check_inputs("sequential_routing_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)))
    if num_iter < 1:
        raise ValueError("need num_iter >= 1 (got %d)" % num_iter)
    lib = _lib("sdr_fwd")
    _check_geometry(lib, "sdr_fwd", u, wgt, bias)
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    if v_init is not None:
        _check_inputs("sequential_routing_cuda", u, (("v_init", v_init, 3),))
        if tuple(v_init.shape) != (batch, out_n, out_d):
            raise ValueError("v_init must be %s, got %s" % (
                (batch, out_n, out_d), tuple(v_init.shape)))
    if step_valid is not None:
        if (step_valid.device != u.device or not step_valid.is_contiguous()
                or step_valid.dtype != torch.bool
                or tuple(step_valid.shape) != (batch, seq_len)):
            raise ValueError(
                "step_valid must be a contiguous bool %s tensor on %s, got "
                "%s %s on %s" % ((batch, seq_len), u.device, step_valid.dtype,
                                 tuple(step_valid.shape), step_valid.device))
        step_valid = step_valid.view(torch.uint8)
    out = torch.empty((batch, seq_len, out_n, out_d), dtype=torch.float32,
                      device=u.device)
    scratch = torch.empty(
        lib.sdr_fwd_scratch_floats(batch, seq_len, in_n, in_d, out_n, out_d),
        dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = lib.sdr_fwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(),
            None if v_init is None else v_init.data_ptr(),
            None if step_valid is None else step_valid.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), batch, seq_len, in_n, in_d,
            out_n, out_d, num_iter, int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_fwd", err)
    sequential_routing_cuda.launches += 2  # prediction, recurrence
    return out


sequential_routing_cuda.launches = 0


def sequential_routing_bwd_cuda(u, wgt, bias, vs, dvs, mask_pad_capsule):
    """The fused SDR backward on the card (K2), one routing iteration: same
    contract as ``sequential_routing_bwd``.

    u [B, T, in_n, in_d], wgt, bias, the forward's output vs and its
    cotangent dvs [B, T, out_n, out_d], float32, contiguous, on one CUDA
    device -> (du, dW, db). Allocates the recomputed u_hat and the
    kernels' scratch: the factors of its cotangent (c, da, ds), the weight
    gradient's partials and, for geometries whose partial sums do not fit
    in shared memory, the recurrence's per-warp sums. Raises on anything
    the kernels do not take; never
    falls back to the plain version. ``sequential_routing_bwd_cuda.launches``
    counts its kernel launches: four per call, the prediction, the
    reverse-time recurrence, the weight gradient and its reduction.
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
    with torch.cuda.device(u.device):
        # the weight gradient's partials follow the card's SM count
        floats = lib.sdr_bwd_scratch_floats(batch, seq_len, in_n, in_d, out_n,
                                            out_d)
        if floats < 0:
            raise RuntimeError("sdr_bwd: no weight-gradient plan for %s on %s"
                               % (tuple(wgt.shape), u.device))
        scratch = torch.empty(floats, dtype=torch.float32, device=u.device)
        u_hat = torch.empty(
            (batch, seq_len, in_n, _plain().row_pitch(out_n * out_d)),
            dtype=torch.float32, device=u.device)
        err = lib.sdr_bwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), vs.data_ptr(),
            dvs.data_ptr(), u_hat.data_ptr(), scratch.data_ptr(),
            du.data_ptr(), dwgt.data_ptr(), dbias.data_ptr(),
            batch, seq_len, in_n, in_d, out_n, out_d,
            int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_bwd", err)
    # prediction, reverse-time recurrence, weight gradient, reduction
    sequential_routing_bwd_cuda.launches += 4
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
        return (*_plain_loop_grads(u, wgt, bias, ctx, dout), None, None)


SCAN_PLAN_FIELDS = ("batch_tile", "clusters", "cluster", "rows", "w_resident",
                    "uhat_buffers", "ring_steps", "smem_bytes")


def scan_plan(name, u, wgt, time_block=8):
    """The launch plan K3 (``name`` "sdr_scan_fwd") or K4 ("sdr_scan_bwd")
    takes for these CUDA tensors on their device, as a dict of
    ``SCAN_PLAN_FIELDS``: utterances a cluster, clusters, CTAs a cluster,
    most rows a CTA owns, whether W's slice stays in shared memory, u_hat
    buffers (2: the next step's is formed during the cluster barriers),
    steps of u a ring slot stages, and dynamic shared memory."""
    fields = (ctypes.c_int * len(SCAN_PLAN_FIELDS))()
    batch, seq_len, in_n, in_d = u.shape
    with torch.cuda.device(u.device):
        err = getattr(_lib(name), name + "_plan")(
            batch, seq_len, in_n, in_d, wgt.shape[1], wgt.shape[2],
            time_block, ctypes.addressof(fields))
    if err:
        raise ValueError("%s has no plan for u %s, W %s" % (
            name, tuple(u.shape), tuple(wgt.shape)))
    return dict(zip(SCAN_PLAN_FIELDS, fields))


def _scan_scratch(lib, name, u, wgt, time_block):
    batch, seq_len, in_n, in_d = u.shape
    floats = getattr(lib, name + "_scratch_floats")(
        batch, seq_len, in_n, in_d, wgt.shape[1], wgt.shape[2], time_block)
    return torch.empty(max(floats, 1), dtype=torch.float32, device=u.device)


def sequential_routing_scan_cuda(u, wgt, bias, num_iter, mask_pad_capsule,
                                 time_block=8):
    """The cluster-scan SDR forward on the card (K3): same contract as
    ``sequential_routing`` and the same inputs as
    ``sequential_routing_cuda``. A thread-block cluster routes a tile of
    utterances, each CTA a slice of in-capsule rows with W's slice in
    shared memory; ``time_block`` steps of u are staged at a time (the
    output does not depend on it, bit for bit). Allocates the scratch for
    buffers that do not fit in shared memory. Raises on anything the kernel
    does not take, or if the cluster launch is refused; it never falls back
    to the plain version. ``sequential_routing_scan_cuda.launches`` counts
    the kernel's launches, one per call.
    """
    _check_inputs("sequential_routing_scan_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)))
    if num_iter < 1:
        raise ValueError("need num_iter >= 1 (got %d)" % num_iter)
    _check_time_block(time_block)
    lib = _lib("sdr_scan_fwd")
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    with torch.cuda.device(u.device):
        _check_geometry(lib, "sdr_scan_fwd", u, wgt, bias, time_block)
        out = torch.empty((batch, seq_len, out_n, out_d),
                          dtype=torch.float32, device=u.device)
        scratch = _scan_scratch(lib, "sdr_scan_fwd", u, wgt, time_block)
        err = lib.sdr_scan_fwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), batch, seq_len, in_n, in_d, out_n, out_d,
            num_iter, int(bool(mask_pad_capsule)), time_block,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_scan_fwd", err)
    sequential_routing_scan_cuda.launches += 1
    return out


sequential_routing_scan_cuda.launches = 0


def sequential_routing_scan_bwd_cuda(u, wgt, bias, vs, dvs, mask_pad_capsule,
                                     time_block=8):
    """K3's backward on the card (K4), one routing iteration: same contract
    as ``sequential_routing_bwd``. The clusters are K3's; dW and db are
    summed inside the kernel, in the CTA that owns the rows, into one
    partial per cluster; the wrapper allocates that scratch (and the
    buffers that do not fit in shared memory). Raises on anything the
    kernel does not take, or if the cluster launch is refused; never falls
    back to the plain version. ``sequential_routing_scan_bwd_cuda.launches``
    counts its kernel launches: two per call, the reverse-time cluster scan
    and the fixed-order reduction of the clusters' partials into dW and db.
    """
    _check_inputs("sequential_routing_scan_bwd_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3),
                   ("vs", vs, 4), ("dvs", dvs, 4)))
    _check_time_block(time_block)
    lib = _lib("sdr_scan_bwd")
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    for name, x in (("vs", vs), ("dvs", dvs)):
        if tuple(x.shape) != (batch, seq_len, out_n, out_d):
            raise ValueError("%s must be %s, got %s" % (
                name, (batch, seq_len, out_n, out_d), tuple(x.shape)))
    with torch.cuda.device(u.device):
        _check_geometry(lib, "sdr_scan_bwd", u, wgt, bias, time_block)
        du = torch.empty_like(u)
        dwgt = torch.empty_like(wgt)
        dbias = torch.empty_like(bias)
        scratch = _scan_scratch(lib, "sdr_scan_bwd", u, wgt, time_block)
        err = lib.sdr_scan_bwd(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), vs.data_ptr(),
            dvs.data_ptr(), du.data_ptr(), dwgt.data_ptr(), dbias.data_ptr(),
            scratch.data_ptr(), batch, seq_len, in_n, in_d, out_n, out_d,
            int(bool(mask_pad_capsule)), time_block,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_scan_bwd", err)
    sequential_routing_scan_bwd_cuda.launches += 2  # scan, reduction
    return du, dwgt, dbias


sequential_routing_scan_bwd_cuda.launches = 0


class SDRScanFunction(torch.autograd.Function):
    """SDR through K3 and K4 (the cluster scans), the port of the custom VJP
    ``srf_tpu/ops/routing_pallas.py:sequential_routing_pallas_scan``.

    forward: K3 on a CUDA tensor, the plain ``sequential_routing`` on a CPU
    tensor; saves u, W, bias and the output, the JAX ``_v6_fwd``'s
    residuals. backward: with one routing iteration K4 on CUDA and the plain
    ``sequential_routing_bwd`` on the CPU; with more, autograd through the
    plain loop recomputed from the saved inputs (the JAX ``_v6_bwd`` does
    the same), counted in ``SDRScanFunction.plain_backwards``. ``time_block``
    is not differentiated. Only ``num_iter`` chooses; nothing falls back on
    failure.
    """

    plain_backwards = 0

    @staticmethod
    def forward(ctx, u, wgt, bias, num_iter, mask_pad_capsule, time_block):
        _check_time_block(time_block)
        if u.is_cuda:
            out = sequential_routing_scan_cuda(u, wgt, bias, num_iter,
                                               mask_pad_capsule, time_block)
        else:
            out = _plain().sequential_routing(u, wgt, bias, num_iter,
                                              mask_pad_capsule)
        ctx.save_for_backward(u, wgt, bias, out)
        ctx.num_iter = num_iter
        ctx.mask_pad_capsule = mask_pad_capsule
        ctx.time_block = time_block
        return out

    @staticmethod
    def backward(ctx, dout):
        u, wgt, bias, out = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.num_iter == 1:
            if u.is_cuda:
                du, dwgt, dbias = sequential_routing_scan_bwd_cuda(
                    u, wgt, bias, out, dout, ctx.mask_pad_capsule,
                    ctx.time_block)
            else:
                du, dwgt, dbias = _plain().sequential_routing_bwd(
                    u, wgt, bias, out, dout, ctx.mask_pad_capsule)
            return du, dwgt, dbias, None, None, None
        SDRScanFunction.plain_backwards += 1
        return (*_plain_loop_grads(u, wgt, bias, ctx, dout), None, None, None)


def sequential_routing_scan(u, wgt, bias, num_iter, mask_pad_capsule,
                            time_block=8):
    """SDR with its fused backward through K3 and K4: the counterpart of
    ``srf_tpu/ops/routing_pallas.py:sequential_routing_pallas_scan``, with
    the same contract as ``ops.routing.sequential_routing``. An entry point
    of the ops layer; no model path calls it (none does in JAX either).
    ``time_block`` (>= 1) is the number of steps the kernels stage at once.
    """
    return SDRScanFunction.apply(u, wgt, bias, num_iter, mask_pad_capsule,
                                 time_block)


def sequential_routing_stream(u, wgt, bias, num_iter, mask_pad_capsule,
                              v_init=None, step_valid=None):
    """SDR forward with an initial carry and a per-step mask: the streaming
    block's routing (``models/srf.py`` ``route_block``), the counterpart of
    JAX's ``sequential_routing(..., v_init, step_valid)`` scan.

    ``v_init`` [B, out_n, out_d] or None (zeros); ``step_valid`` [T] or
    [B, T] bool or None (every step valid): an invalid step emits zeros
    and leaves a zero carry. A CUDA tensor goes to K1
    (``sequential_routing_cuda`` with both inputs), a CPU tensor to the
    plain ``sequential_routing``; nothing else decides. Forward only: no
    training path passes a carry, so inputs that autograd would record
    raise.
    """
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (u, wgt, bias, v_init)):
        raise RuntimeError(
            "sequential_routing_stream is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode()")
    if step_valid is not None:
        step_valid = torch.as_tensor(step_valid, device=u.device)
        if step_valid.dim() == 1:
            step_valid = step_valid.expand(u.shape[0], -1)
    if not u.is_cuda:
        return _plain().sequential_routing(u, wgt, bias, num_iter,
                                           mask_pad_capsule, v_init,
                                           step_valid)
    return sequential_routing_cuda(
        u.contiguous(), wgt.contiguous(), bias.contiguous(), num_iter,
        mask_pad_capsule, None if v_init is None else v_init.contiguous(),
        None if step_valid is None else step_valid.contiguous())


def _plain_loop_grads(u, wgt, bias, ctx, dout):
    """(du, dW, db) by autograd through the plain loop recomputed from the
    saved inputs: the backward of more than one routing iteration."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_() for x in (u, wgt, bias)]
        recomputed = _plain().sequential_routing(
            *inputs, ctx.num_iter, ctx.mask_pad_capsule)
        return torch.autograd.grad(recomputed, inputs, dout)


def _plain():
    # ops.routing imports this module for SDRFunction; the plain versions
    # are looked up at call time so that either module may be imported first
    from srf_tpu_torch.ops import routing

    return routing
