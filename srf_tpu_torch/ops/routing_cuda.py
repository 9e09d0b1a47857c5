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
kernels and CPU tensors to the plain versions. K1 and K2 have bf16
variants (bf16 routing, ``--tpu-routing-bf16``; ``sdr_fwd_bf16`` and
``sdr_bwd_bf16`` in the same sources), whose plain versions are
``sequential_routing(..., bf16=True)`` and ``sequential_routing_bwd_bf16``:
``sequential_routing_cuda`` and ``sequential_routing_bwd_cuda`` take
float32 tensors to K1 and K2 and bf16 tensors to the variants, and raise on
any other dtype. The libraries are compiled
with nvcc when the first CUDA tensor arrives (see ``cuda_build``), never at
import.

K1-tp and K2-tp (``csrc/sdr_tp.cu``) route a shard of the out capsules on
the ``model`` mesh axis with the softmax split across the ranks, joined by
``SDRTPFunction``: the prediction kernel (``sdr_fwd.cu``'s
``sdr_predict``), then either one persistent kernel that walks time on
the card and exchanges the rows' statistics with its peers itself,
through flags in device memory (:func:`tp_forward_persistent`,
:func:`tp_backward_persistent`), or a host loop over time of two launches
and one exchange (c10d on the current stream) a step and iteration
(:func:`tp_forward_steps`, :func:`tp_backward_steps`); then, for K2-tp,
K2's weight-gradient kernels on the factors (``sdr_bwd.cu``'s
``sdr_bwd_wgrad``). Where the peers' buffers live is the transport,
chosen once per group from its ranks' hosts and cards
(:func:`tp_transport`): "ipc" (a card a rank, one host: CUDA IPC) or
"host_loop" (one rank, ranks sharing a card, or ranks spanning hosts).
The co-launch (every shard in this process, one launch on one card) is
reached only through :func:`sequential_routing_tp_colaunch_cuda` and its
backward. Their plain versions are ``ops/routing.py:sequential_routing_tp``
and ``sequential_routing_tp_bwd``. Their bf16 instances, K1-tp-bf16 and
K2-tp-bf16 (bf16 u, W and b: ``sdr_fwd.cu``'s ``sdr_predict_bf16``, the
``sdr_tp.cu`` kernels' BF instances, ``sdr_bwd.cu``'s
``sdr_bwd_wgrad_bf16``), compute ``sequential_routing_tp(..., bf16=True)``
and ``sequential_routing_tp_bwd_bf16``; K1-tp with an initial carry and a
step mask, K1-tp-stream, computes ``sequential_routing_tp(..., v_init,
step_valid)``, streaming on a shard (:func:`sequential_routing_tp_stream`).
Every wrapper counts its launches by variant (``launches``,
``launches_bf16``, ``launches_stream``); :data:`wgrad_launches` counts
the weight-gradient launches of K2 and K2-tp (every variant) by the path
their plan took: "tiled" (W[n] whole, dW in registers) or "general";
:data:`predict_launches` the prediction launches of K1, K2 and K1-tp (every
variant) by the path theirs took: "tiled" (in_d in one tile, W's rows in
registers) or "general" (in_d in tiles through u_hat).
"""

import atexit
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


# K2's and K2-tp's weight-gradient launches by plan path
wgrad_launches = {"tiled": 0, "general": 0}
# K1's, K2's and K1-tp's prediction launches by plan path
predict_launches = {"tiled": 0, "general": 0}


@functools.lru_cache(maxsize=None)
def _lib(name):
    lib = ctypes.CDLL(cuda_build.build([name])[name])
    # K1 and K2 hold their bf16 variants' entry points too
    entries = ((name, name + "_bf16") if name in ("sdr_fwd", "sdr_bwd")
               else (name,))
    for entry in entries:
        getattr(lib, entry).argtypes = _LAUNCH_ARGTYPES[name]
        getattr(lib, entry).restype = ctypes.c_int
        fn = getattr(lib, entry + "_smem_bytes")
        fn.argtypes = [ctypes.c_int] * _PLAN_ARGS[name]
        fn.restype = ctypes.c_int
        fn = getattr(lib, entry + "_scratch_floats")
        fn.argtypes = [ctypes.c_int] * (7 if name.startswith("sdr_scan")
                                        else 6)
        fn.restype = ctypes.c_longlong
    if name.startswith("sdr_scan"):
        fn = getattr(lib, name + "_plan")
        fn.argtypes = [ctypes.c_int] * _PLAN_ARGS[name] + [_VOID_P]
        fn.restype = ctypes.c_int
    if name == "sdr_bwd":
        lib.sdr_bwd_wgrad_tiled.argtypes = [ctypes.c_int] * 3
        lib.sdr_bwd_wgrad_tiled.restype = ctypes.c_int
    if name == "sdr_fwd":
        lib.sdr_predict_tiled.argtypes = [ctypes.c_int]
        lib.sdr_predict_tiled.restype = ctypes.c_int
    error_string = getattr(lib, name + "_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgrad_path(in_d, out_n, out_d):
    """"tiled" or "general": the weight-gradient plan's path for a
    geometry (``csrc/sdr_plan.cuh`` ``plan_wgrad``)."""
    tiled = _lib("sdr_bwd").sdr_bwd_wgrad_tiled(in_d, out_n, out_d)
    return "tiled" if tiled else "general"


def _count_wgrad(wgt):
    """One weight-gradient launch more on W's plan path."""
    wgrad_launches[_wgrad_path(wgt.shape[3], wgt.shape[1], wgt.shape[2])] += 1


@functools.lru_cache(maxsize=None)
def _predict_path(in_d):
    """"tiled" or "general": the prediction plan's path for in_d, the only
    dimension it follows (``csrc/sdr_plan.cuh`` ``plan_predict``)."""
    return "tiled" if _lib("sdr_fwd").sdr_predict_tiled(in_d) else "general"


def _count_predict(wgt):
    """One prediction launch more on W's plan path."""
    predict_launches[_predict_path(wgt.shape[-1])] += 1


def _check_inputs(fn_name, u, tensors, dtype=torch.float32):
    """Device, dtype, rank and contiguity checks shared by the wrappers;
    ``tensors`` is ((name, tensor, ndim), ...), each of ``dtype``."""
    if not u.is_cuda:
        raise ValueError(
            "%s takes CUDA tensors (got %s); the plain version is "
            "ops.routing.%s" % (fn_name, u.device,
                                fn_name[:-len("_cuda")].replace("_scan", ""))
        )
    for name, x, ndim in tensors:
        if x.device != u.device:
            raise ValueError("%s is on %s, u on %s" % (name, x.device, u.device))
        if x.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, x.dtype))
        if x.dim() != ndim:
            raise ValueError("%s must be %d-D, got %s" % (name, ndim, tuple(x.shape)))
        if not x.is_contiguous():
            raise ValueError("%s must be contiguous" % name)


def _variant(u):
    """"" for a float32 ``u`` (K1, K2), "_bf16" for bf16 (their bf16
    variants); raises on any other dtype."""
    if u.dtype == torch.float32:
        return ""
    if u.dtype == torch.bfloat16:
        return "_bf16"
    raise TypeError("the SDR kernels take float32 or bfloat16, got %s"
                    % u.dtype)


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
    [B, T, out_n, out_d] float32. Given bf16 u, wgt and bias, K1's bf16
    variant computes ``sequential_routing(..., bf16=True)`` (float32 out,
    u_hat in bf16);
    ``sequential_routing_cuda.launches_bf16`` counts its launches, two per
    call. ``v_init`` [B, out_n, out_d] float32 (the carry
    before step 0; zeros if None) and ``step_valid`` [B, T] bool (an
    invalid step emits zeros and leaves a zero carry; every step valid
    if None), contiguous, on u's device. Allocates the kernels' scratch:
    the prediction vectors u_hat ([B, T, in_n, out_n * out_d rounded up to
    a multiple of 4]) and, for geometries whose partial sums do not fit in
    shared memory, the recurrence's per-warp sums. Raises on anything the
    kernels do not take; it never falls back to the plain version.
    ``sequential_routing_cuda.launches`` counts its kernel launches: two
    per call, the prediction kernel and the recurrence
    (:data:`predict_launches` the prediction's by plan path).
    """
    variant = _variant(u)
    _check_inputs("sequential_routing_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)), u.dtype)
    if num_iter < 1:
        raise ValueError("need num_iter >= 1 (got %d)" % num_iter)
    lib = _lib("sdr_fwd")
    entry = "sdr_fwd" + variant
    _check_geometry(lib, entry, u, wgt, bias)
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
        getattr(lib, entry + "_scratch_floats")(batch, seq_len, in_n, in_d,
                                               out_n, out_d),
        dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = getattr(lib, entry)(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(),
            None if v_init is None else v_init.data_ptr(),
            None if step_valid is None else step_valid.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), batch, seq_len, in_n, in_d,
            out_n, out_d, num_iter, int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_fwd", err)
    _count_predict(wgt)
    if variant:
        sequential_routing_cuda.launches_bf16 += 2
    else:
        sequential_routing_cuda.launches += 2  # prediction, recurrence
    return out


sequential_routing_cuda.launches = 0
sequential_routing_cuda.launches_bf16 = 0


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
    reverse-time recurrence, the weight gradient and its reduction
    (:data:`predict_launches` the prediction's and :data:`wgrad_launches`
    the weight gradient's by plan path).

    Given bf16 u, wgt and bias (vs and dvs float32: the bf16 variant's
    output and its cotangent), K2's bf16 variant computes
    ``sequential_routing_bwd_bf16``: (du, dW, db) in bf16, each a float32
    sum rounded once. ``sequential_routing_bwd_cuda.launches_bf16`` counts
    its launches, four per call.
    """
    variant = _variant(u)
    _check_inputs("sequential_routing_bwd_cuda", u,
                  (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)), u.dtype)
    _check_inputs("sequential_routing_bwd_cuda", u,
                  (("vs", vs, 4), ("dvs", dvs, 4)))
    lib = _lib("sdr_bwd")
    entry = "sdr_bwd" + variant
    _check_geometry(lib, entry, u, wgt, bias)
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    for name, x in (("vs", vs), ("dvs", dvs)):
        if tuple(x.shape) != (batch, seq_len, out_n, out_d):
            raise ValueError("%s must be %s, got %s" % (
                name, (batch, seq_len, out_n, out_d), tuple(x.shape)))
    # the kernels' sums are float32 (the bf16 variant's are rounded below)
    du, dwgt, dbias = (torch.empty_like(x, dtype=torch.float32)
                       for x in (u, wgt, bias))
    with torch.cuda.device(u.device):
        # the weight gradient's partials follow the card's SM count
        floats = getattr(lib, entry + "_scratch_floats")(
            batch, seq_len, in_n, in_d, out_n, out_d)
        if floats < 0:
            raise RuntimeError("%s: no weight-gradient plan for %s on %s"
                               % (entry, tuple(wgt.shape), u.device))
        scratch = torch.empty(floats, dtype=torch.float32, device=u.device)
        uhat_dtype = torch.bfloat16 if variant else torch.float32
        u_hat = torch.empty(
            (batch, seq_len, in_n,
             _plain().row_pitch(out_n * out_d, uhat_dtype.itemsize)),
            dtype=uhat_dtype, device=u.device)
        err = getattr(lib, entry)(
            u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), vs.data_ptr(),
            dvs.data_ptr(), u_hat.data_ptr(), scratch.data_ptr(),
            du.data_ptr(), dwgt.data_ptr(), dbias.data_ptr(),
            batch, seq_len, in_n, in_d, out_n, out_d,
            int(bool(mask_pad_capsule)),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _raise_on(lib, "sdr_bwd", err)
    _count_predict(wgt)
    _count_wgrad(wgt)
    if variant:
        sequential_routing_bwd_cuda.launches_bf16 += 4
        return tuple(x.to(torch.bfloat16) for x in (du, dwgt, dbias))
    # prediction, reverse-time recurrence, weight gradient, reduction
    sequential_routing_bwd_cuda.launches += 4
    return du, dwgt, dbias


sequential_routing_bwd_cuda.launches = 0
sequential_routing_bwd_cuda.launches_bf16 = 0


class SDRFunction(torch.autograd.Function):
    """SDR with its fused backward, the port of the custom VJP
    ``srf_tpu/ops/routing_pallas.py:sequential_routing_pallas``.

    forward: u, W and bias are cast to float32 (JAX's SDR computes in
    float32 on bf16 inputs, ``srf_tpu/ops/routing.py:263-283``), or to bf16
    with ``bf16`` (bf16 routing); then K1 (its bf16 variant) on a CUDA
    tensor, the plain ``sequential_routing`` on a CPU tensor; the float32
    output is cast to u's dtype. Saves the cast u, W, bias and the float32
    output, the JAX ``_fwd``'s residuals. backward: with one routing
    iteration K2 (its bf16 variant) on CUDA and the plain
    ``sequential_routing_bwd`` (``sequential_routing_bwd_bf16``) on the
    CPU; with more, autograd through the plain loop recomputed from the
    saved inputs (the JAX ``_bwd`` does the same), counted in
    ``SDRFunction.plain_backwards``; the gradients are cast to the inputs'
    dtypes. Only the device, ``bf16`` and ``num_iter`` choose; nothing
    falls back on failure.
    """

    plain_backwards = 0

    @staticmethod
    def forward(ctx, u, wgt, bias, num_iter, mask_pad_capsule, bf16=False):
        ctx.dtypes = (u.dtype, wgt.dtype, bias.dtype)
        # float32 for float32 and narrower inputs (float64 stays, for
        # gradcheck), bf16 in bf16 routing
        cd = torch.bfloat16 if bf16 else _plain()._compute_dtype(u.dtype)
        u, wgt, bias = (x.to(cd).contiguous() for x in (u, wgt, bias))
        if u.is_cuda:
            out = sequential_routing_cuda(u, wgt, bias, num_iter,
                                          mask_pad_capsule)
        else:
            out = _plain().sequential_routing(
                *(x.to(_plain()._compute_dtype(cd)) for x in (u, wgt, bias)),
                num_iter, mask_pad_capsule, bf16=bf16)
        ctx.save_for_backward(u, wgt, bias, out)
        ctx.num_iter = num_iter
        ctx.mask_pad_capsule = mask_pad_capsule
        ctx.bf16 = bf16
        return out.to(ctx.dtypes[0])

    @staticmethod
    def backward(ctx, dout):
        u, wgt, bias, out = ctx.saved_tensors
        dout = dout.to(out.dtype).contiguous()
        if ctx.num_iter == 1 and u.is_cuda:
            grads = sequential_routing_bwd_cuda(u, wgt, bias, out, dout,
                                                ctx.mask_pad_capsule)
        elif ctx.num_iter == 1 and not ctx.bf16:
            grads = _plain().sequential_routing_bwd(u, wgt, bias, out, dout,
                                                    ctx.mask_pad_capsule)
        elif ctx.num_iter == 1:
            grads = _plain().sequential_routing_bwd_bf16(
                u, wgt, bias, dout, ctx.mask_pad_capsule)
        else:
            SDRFunction.plain_backwards += 1
            grads = _plain_loop_grads(u, wgt, bias, ctx, dout)
        return (*(g.to(d) for g, d in zip(grads, ctx.dtypes)), None, None,
                None)


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


# ---- K1-tp and K2-tp (csrc/sdr_tp.cu): SDR on a shard of the out capsules


@functools.lru_cache(maxsize=None)
def _tp_libs():
    """(sdr_tp, sdr_fwd, sdr_bwd) with the entries K1-tp and K2-tp take:
    the step kernels, the prediction kernel alone and K2's weight gradient
    on given factors."""
    lib = ctypes.CDLL(cuda_build.build(["sdr_tp"])["sdr_tp"])
    fwd, bwd = _lib("sdr_fwd"), _lib("sdr_bwd")
    declare_tp(lib)
    for name in ("sdr_predict", "sdr_predict_bf16"):
        getattr(fwd, name).argtypes = ([_VOID_P] * 4 + [ctypes.c_int] * 4
                                       + [_VOID_P])
        getattr(fwd, name).restype = ctypes.c_int
    for name in ("sdr_bwd_wgrad", "sdr_bwd_wgrad_bf16"):
        getattr(bwd, name).argtypes = ([_VOID_P] * 10 + [ctypes.c_int] * 6
                                       + [_VOID_P])
        getattr(bwd, name).restype = ctypes.c_int
        getattr(bwd, name + "_part_floats").argtypes = [ctypes.c_int] * 6
        getattr(bwd, name + "_part_floats").restype = ctypes.c_longlong
    return lib, fwd, bwd


def declare_tp(lib):
    """ctypes signatures of csrc/sdr_tp.cu's entries on ``lib`` (the CUDA
    build, or the tests' host build of the same source, which has no IPC
    entries)."""
    int_, ll, ptr = ctypes.c_int, ctypes.c_longlong, _VOID_P
    entries = [
        ("sdr_tp_stats", [ptr] * 4 + [int_] * 9 + [ptr]),
        ("sdr_tp_route", [ptr, ptr, int_] + [ptr] * 5 + [int_] * 8 + [ptr]),
        ("sdr_tp_bwd_a", [ptr] * 9 + [int_] * 8 + [ptr]),
        ("sdr_tp_bwd_b", [ptr] * 6 + [int_] * 7 + [ptr]),
        ("sdr_tp_smem_bytes", [int_] * 3),
        ("sdr_tp_persistent_smem_bytes", [int_] * 5),
        ("sdr_tp_persistent_capacity", [int_] * 5),
        ("sdr_tp_fwd_persistent", [ptr] * 8 + [int_] * 5 + [ll] * 2
         + [int_] * 7 + [ptr]),
        ("sdr_tp_bwd_persistent", [ptr] * 10 + [int_] * 5 + [ll] * 2
         + [int_] * 6 + [ptr])]
    if hasattr(lib, "sdr_tp_ipc_alloc"):
        entries += [("sdr_tp_ipc_alloc", [ll, ptr, ptr]),
                    ("sdr_tp_ipc_open", [ctypes.c_char_p, ptr]),
                    ("sdr_tp_ipc_close", [ptr]), ("sdr_tp_ipc_free", [ptr]),
                    ("sdr_tp_copy", [ptr, ptr, ll])]
    for name, args in entries:
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = int_
    lib.sdr_tp_error_string.argtypes = [int_]
    lib.sdr_tp_error_string.restype = ctypes.c_char_p


def _tp_call(lib, name, *args):
    _raise_on(lib, "sdr_tp", getattr(lib, name)(*args))


def _is_bf16(uhat):
    """1 for a bf16 u_hat (the kernels' bf16 instances), 0 for float32."""
    return int(uhat.dtype == torch.bfloat16)


def _valid_bytes(step_valid):
    """A [B, T] bool step mask as the kernels read it (uint8), or None."""
    return None if step_valid is None else step_valid.view(torch.uint8)


def tp_forward_steps(lib, uhat, out_n, out_d, num_iter, pad_owner, stream,
                     v_init=None, step_valid=None):
    """K1-tp's loop over time after the prediction (a generator): for each
    step and iteration the stats kernel, then it yields this rank's (m, l)
    pairs [B * in_n, 2] and is sent every rank's [ranks, B * in_n, 2], then
    the route kernel. Returns (out [B, T, out_n, out_d], the global (M, L)
    [T, num_iter, B, in_n, 2]). ``uhat`` [B, T, in_n, pitch] from the
    prediction kernel (bf16: the kernels' bf16 instances); ``lib`` the
    sdr_tp library; ``v_init`` [B, out_n, out_d] the carry before step 0
    (zeros if None) and ``step_valid`` [B, T] bool (or None), contiguous
    (K1-tp-stream)."""
    batch, seq_len, in_n = uhat.shape[:3]
    dev = uhat.device
    out = torch.empty((batch, seq_len, out_n, out_d), device=dev)
    stats = torch.empty((seq_len, num_iter, batch, in_n, 2), device=dev)
    vcar = (torch.zeros((batch, out_n * out_d), device=dev) if v_init is None
            else v_init.reshape(batch, out_n * out_d).clone())
    bacc = torch.empty((batch, in_n, out_n), device=dev)
    local = torch.empty((batch * in_n, 2), device=dev)
    valid = _valid_bytes(step_valid)
    geom = (batch, seq_len)
    bf16 = _is_bf16(uhat)
    for t in range(seq_len):
        for it in range(num_iter):
            _tp_call(lib, "sdr_tp_stats", uhat.data_ptr(), vcar.data_ptr(),
                     bacc.data_ptr(), local.data_ptr(), *geom, t, in_n,
                     out_n, out_d, it, int(bool(pad_owner)), bf16, stream)
            gathered = (yield local).contiguous()
            _tp_call(lib, "sdr_tp_route", uhat.data_ptr(),
                     gathered.data_ptr(), gathered.shape[0], bacc.data_ptr(),
                     vcar.data_ptr(), out.data_ptr(), stats[t, it].data_ptr(),
                     None if valid is None else valid.data_ptr(), *geom, t,
                     in_n, out_n, out_d, int(it == num_iter - 1), bf16,
                     stream)
    return out, stats


def tp_backward_steps(lib, uhat, vs, dvs, stats, pad_owner, stream):
    """K2-tp's reverse-time loop (a generator): for each step the first
    kernel, then it yields this rank's row sums [B, in_n] and is sent their
    sum over the ranks, then the second kernel. Returns du_hat's factors
    (c, da [B, T, in_n, out_n], ds [B, T, out_n * out_d]) in K2's layout.
    ``vs`` and ``dvs`` [B, T, out_n, out_d], ``stats`` the forward's
    [T, num_iter, B, in_n, 2]; a bf16 ``uhat``: the bf16 instances."""
    batch, seq_len, in_n = uhat.shape[:3]
    out_n, out_d = vs.shape[2], vs.shape[3]
    dev = uhat.device
    cfac = torch.empty((batch, seq_len, in_n, out_n), device=dev)
    dafac = torch.empty_like(cfac)
    dsfac = torch.empty((batch, seq_len, out_n * out_d), device=dev)
    dc = torch.empty((batch, in_n, out_n), device=dev)
    rowsum = torch.empty((batch, in_n), device=dev)
    carry = torch.zeros((batch, out_n * out_d), device=dev)
    geom = (batch, seq_len)
    bf16 = _is_bf16(uhat)
    for t in range(seq_len - 1, -1, -1):
        _tp_call(lib, "sdr_tp_bwd_a", uhat.data_ptr(), vs.data_ptr(),
                 dvs.data_ptr(), stats[t, 0].data_ptr(), carry.data_ptr(),
                 cfac.data_ptr(), dsfac.data_ptr(), dc.data_ptr(),
                 rowsum.data_ptr(), *geom, t, in_n, out_n, out_d,
                 int(bool(pad_owner)), bf16, stream)
        summed = (yield rowsum).contiguous()
        _tp_call(lib, "sdr_tp_bwd_b", uhat.data_ptr(), cfac.data_ptr(),
                 dc.data_ptr(), summed.data_ptr(), dafac.data_ptr(),
                 carry.data_ptr(), *geom, t, in_n, out_n, out_d, bf16,
                 stream)
    return cfac, dafac, dsfac


def drive(steps, exchange):
    """Run a generator of :func:`tp_forward_steps` or
    :func:`tp_backward_steps`, answering each yield with
    ``exchange(yielded)``; returns its result."""
    try:
        sent = next(steps)
        while True:
            sent = steps.send(exchange(sent))
    except StopIteration as stop:
        return stop.value


# ---- the persistent kernels' transports and exchange buffers

TP_TIMEOUT_S = 10.0  # a co-launch's wait for its other shards, at most
TP_MAX_RANKS = 8     # csrc/sdr_tp.cu kMaxRanks
_STATUS_WORDS = 8    # csrc/sdr_tp.cu kStatusWords
_TRANSPORT = {}      # id(group) -> (group, transport)
_LOCAL = {}          # (ranks, device) -> TPExchange
_IPC = {}            # id(group) -> TPExchange
_IPC_HELD = []       # (own buffer, [opened peers' buffers]) to release


def choose_transport(peers, reach):
    """The transport of a group whose ranks sit at ``peers``, [(host, card
    uuid)] in rank order, where ``reach`` is {card uuid: the uuids of the
    cards it can map as a peer}: "ipc" where there are 2 to TP_MAX_RANKS
    ranks, every one with a card of its own, all on one host, and each
    card can reach every other's memory; else "host_loop" (one rank: its
    loop has no exchange). The persistent kernels spin on flags in a
    peer's memory, which CUDA IPC maps only where the cards have peer
    access (NVLink, or PCIe peer to peer): without it the group takes the
    host loop. Topology only: nothing else chooses, and a failure on the
    chosen transport raises."""
    hosts = {host for host, _ in peers}
    cards = {card for _, card in peers}
    if not (len(hosts) == 1 and len(cards) == len(peers)
            and 2 <= len(peers) <= TP_MAX_RANKS):
        return "host_loop"
    if any(b not in reach.get(a, ()) for a in cards for b in cards
           if a != b):
        return "host_loop"
    return "ipc"


def peer_cards(index):
    """The uuids of the cards that card ``index`` can map as a peer
    (``torch.cuda.can_device_access_peer``), of those this process sees."""
    return sorted(str(torch.cuda.get_device_properties(j).uuid)
                  for j in range(torch.cuda.device_count())
                  if j != index and torch.cuda.can_device_access_peer(index,
                                                                      j))


def tp_transport(group):
    """The transport of ``group`` (the ``model`` ranks; None: this rank
    alone): at the group's first call, every rank's (hostname, uuid of its
    current card, :func:`peer_cards` of it) gathered over the host group
    and :func:`choose_transport`; cached. The first call is collective:
    every rank of the world makes it at the same point, as every rank
    makes the same layer calls."""
    from srf_tpu_torch.parallel import distributed

    if group is None or distributed.world_size(group) == 1:
        return "host_loop"
    if id(group) not in _TRANSPORT:
        import socket

        import torch.distributed as dist

        index = torch.cuda.current_device()
        card = str(torch.cuda.get_device_properties(index).uuid)
        everyone = distributed.host_all_gather(
            (socket.gethostname(), card, peer_cards(index)))
        ranks = dist.get_process_group_ranks(group)
        peers = [everyone[r][:2] for r in ranks]
        reach = {everyone[r][1]: set(everyone[r][2]) for r in ranks}
        _TRANSPORT[id(group)] = (group, choose_transport(peers, reach))
    return _TRANSPORT[id(group)][1]


class TPExchange:
    """A rank set's exchange buffers (``csrc/sdr_tp.cu``): every rank's
    xbuf [2, ranks, cap, 2] float32 and flags [ranks, cap] uint64, zeroed
    once, as addresses (ctypes arrays ``xbufs``, ``flags``) in this
    process; ``status`` this process's status words [8] int64;
    ``timeout_s`` how long a wait for a peer lasts before the launch gives
    up; ``epochs`` the exchanges the set has made, the next call's epoch
    base (equal on every rank: every rank makes the same calls);
    ``pending`` the launches whose status words are not read yet (see
    :func:`check_exchange`). ``keep`` holds what owns the buffers."""

    def __init__(self, ranks, cap, xbufs, flags, status, timeout_s, keep=()):
        self.ranks, self.cap = ranks, cap
        self.xbufs = (_VOID_P * ranks)(*xbufs)
        self.flags = (_VOID_P * ranks)(*flags)
        self.status, self.timeout_s, self.keep = status, timeout_s, keep
        self.epochs = 0
        self.pending = []

    def carry_from(self, old):
        """Take over ``old``'s count of exchanges and its unread launches
        (this exchange replaces it)."""
        if old is not None:
            self.epochs, self.pending = old.epochs, old.pending
        return self


def _capacity(rows):
    """Rows of an exchange buffer for B * in_n = ``rows``: a power of two,
    at least 1024, so that few batch shapes grow it."""
    return max(1024, 1 << (rows - 1).bit_length())


def new_local_exchange(ranks, rows, device):
    """A fresh exchange for ``ranks`` shards in this process (a co-launch):
    the ranks' buffers slices of one allocation on ``device`` (the CPU for
    the tests' host build); a wait gives up after TP_TIMEOUT_S."""
    cap = _capacity(rows)
    xbuf = torch.zeros((ranks, 2, ranks, cap, 2), device=device)
    flags = torch.zeros((ranks, ranks, cap), dtype=torch.int64,
                        device=device)
    status = torch.zeros(_STATUS_WORDS, dtype=torch.int64, device=device)
    return TPExchange(ranks, cap, [x.data_ptr() for x in xbuf],
                      [f.data_ptr() for f in flags], status, TP_TIMEOUT_S,
                      keep=(xbuf, flags))


def local_exchange(ranks, rows, device):
    """The co-launch's exchange for ``ranks`` shards on ``device``, cached,
    replaced by a larger one (its count of exchanges carried over) where it
    holds fewer than ``rows`` = B * in_n."""
    key = (ranks, str(device))
    old = _LOCAL.get(key)
    if old is None or old.cap < rows:
        _LOCAL[key] = new_local_exchange(ranks, rows, device).carry_from(old)
    return _LOCAL[key]


def ipc_exchange(group, rows, device):
    """Transport 2's exchange for ``group``: this rank's buffer (xbuf, then
    flags) allocated and zeroed by ``csrc/sdr_tp.cu`` outside torch's
    caching allocator (whose blocks would give their segment's IPC handle),
    its handle gathered over the host group, every peer's opened with lazy
    peer access; a wait gives up after the group's own timeout
    (:func:`group_timeout_s`), as its collectives do; cached per group,
    replaced by a larger one (on every rank at the same call) where it
    holds fewer than ``rows``. Buffers are released at exit
    (:func:`release_ipc`), none before: a peer may still map them.
    Collective where it allocates."""
    from srf_tpu_torch.parallel import distributed

    old = _IPC.get(id(group))
    if old is not None and old.cap >= rows:
        return old
    import torch.distributed as dist

    lib = _tp_libs()[0]
    ranks, me = distributed.world_size(group), distributed.rank(group)
    cap = _capacity(rows)
    xbuf_bytes = 16 * ranks * cap
    own, handle = _VOID_P(), ctypes.create_string_buffer(64)
    _raise_on(lib, "sdr_tp", lib.sdr_tp_ipc_alloc(
        xbuf_bytes + 8 * ranks * cap, ctypes.byref(own), handle))
    opened = []
    _IPC_HELD.append((own.value, opened))
    handles = distributed.host_all_gather(handle.raw)
    bases = []
    for q, world_rank in enumerate(dist.get_process_group_ranks(group)):
        if q == me:
            bases.append(own.value)
            continue
        peer = _VOID_P()
        _raise_on(lib, "sdr_tp", lib.sdr_tp_ipc_open(handles[world_rank],
                                                     ctypes.byref(peer)))
        opened.append(peer.value)
        bases.append(peer.value)
    status = torch.zeros(_STATUS_WORDS, dtype=torch.int64, device=device)
    new = TPExchange(ranks, cap, bases, [b + xbuf_bytes for b in bases],
                     status, group_timeout_s(group, device), keep=(group,))
    _IPC[id(group)] = new.carry_from(old)
    return new


def group_timeout_s(group, device):
    """``group``'s own timeout in seconds (its backend's for ``device``):
    how long its collectives wait for a peer."""
    return group._get_backend(device).options._timeout.total_seconds()


def release_ipc(barrier=None):
    """Close every opened peer buffer, then (after ``barrier()``, where
    given: every rank has closed its mappings) free this rank's own; at
    exit without a barrier."""
    if not _IPC_HELD:
        return
    lib = _tp_libs()[0]
    for _, opened in _IPC_HELD:
        for peer in opened:
            lib.sdr_tp_ipc_close(peer)
    if barrier is not None:
        barrier()
    for own, _ in _IPC_HELD:
        lib.sdr_tp_ipc_free(own)
    _IPC_HELD.clear()
    _IPC.clear()


atexit.register(release_ipc)


def _ptrs(tensors):
    return (_VOID_P * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_persistent(lib, name, batch, local_ranks, in_n, out_n, out_d,
                      backward, bf16=0):
    """Raises where the persistent kernel (``bf16``: its bf16 instance)
    takes not this geometry, or its batch x local_ranks blocks cannot all
    be resident on the card."""
    if lib.sdr_tp_persistent_smem_bytes(in_n, out_n, out_d, backward,
                                        bf16) < 0:
        raise ValueError(
            "%s: capsule geometry (in_n, O_local, out_d) = (%d, %d, %d) does "
            "not fit the persistent kernel's shared memory"
            % (name, in_n, out_n, out_d))
    held = lib.sdr_tp_persistent_capacity(in_n, out_n, out_d, backward,
                                          bf16)
    if batch * local_ranks > held:
        raise ValueError(
            "%s: a cooperative launch of %d blocks (B %d x %d ranks) cannot "
            "be resident at once: the card holds %d of this kernel"
            % (name, batch * local_ranks, batch, local_ranks, held))


def _persistent_done(lib, name, err, exchange, steps):
    """After a persistent launch: raises on its launch error, counts its
    ``steps`` exchanges and queues a copy of the status words behind the
    launch (no wait: on the card the copy lands in pinned memory when the
    launch ends); then :func:`check_exchange` reads the copies of the
    launches that have ended, at once on the CPU (the host build's launch
    has ended when it returns)."""
    _raise_on(lib, "sdr_tp", err)
    exchange.epochs += steps
    if exchange.status.is_cuda:
        words = torch.empty(_STATUS_WORDS, dtype=torch.int64,
                            pin_memory=True)
        words.copy_(exchange.status, non_blocking=True)
        ended = torch.cuda.Event()
        ended.record()
    else:
        words, ended = exchange.status.clone(), None
    exchange.pending.append((ended, words, name))
    check_exchange(exchange, wait=ended is None)


def check_exchange(exchange, wait=False):
    """Reads the status words of ``exchange``'s launches that have ended
    (with ``wait``: of every launch, after waiting for them), oldest first,
    and raises if a wait in one gave up, naming the launch, the rank, the
    utterance, the step, the iteration, the epoch and the peer it waited
    for; the status words are then cleared. Every persistent launch reads
    those of the launches before it, so a timed-out launch raises at a
    later call without a wait for the card at every call."""
    while exchange.pending:
        ended, words, name = exchange.pending[0]
        if ended is not None:
            if not wait and not ended.query():
                return
            ended.synchronize()
        exchange.pending.pop(0)
        words = words.tolist()
        if words[0]:
            exchange.pending.clear()
            exchange.status.zero_()
            rank, utt, t, it, epoch, peer = words[1:7]
            raise RuntimeError(
                "%s: rank %d waited more than %.1f s for rank %d's exchange "
                "of utterance %d, step %d, iteration %d (epoch %d): a rank "
                "that never ran, or a fault in the exchange"
                % (name, rank, exchange.timeout_s, peer, utt, t, it, epoch))


def check_tp_status():
    """Waits for every persistent launch of this process and raises as
    :func:`check_exchange` if a wait in one gave up."""
    for exchange in list(_LOCAL.values()) + list(_IPC.values()):
        check_exchange(exchange, wait=True)


def tp_forward_persistent(lib, uhats, out_n, out_d, num_iter, pad_rank,
                          exchange, rank0, stream, v_inits=None,
                          step_valid=None):
    """K1-tp's persistent kernel after the prediction: one cooperative
    launch for ranks rank0 .. rank0 + len(uhats) - 1 of ``exchange``'s
    set, ``uhats`` [B, T, in_n, pitch] their u_hat in rank order (bf16:
    the bf16 instance); ``pad_rank`` the rank that holds the PAD capsule,
    or -1; ``v_inits`` each launched rank's carry before step 0 [B, out_n,
    out_d] (or None: zeros) and ``step_valid`` [B, T] bool (or None),
    contiguous (K1-tp-stream). Returns ([out [B, T, out_n, out_d]], [the
    global (M, L) [T, num_iter, B, in_n, 2]]) per launched rank. ``lib``
    the sdr_tp library (CUDA, or the tests' host build on CPU tensors)."""
    batch, seq_len, in_n = uhats[0].shape[:3]
    bf16 = _is_bf16(uhats[0])
    _check_persistent(lib, "K1-tp", batch, len(uhats), in_n, out_n, out_d,
                      0, bf16)
    dev = uhats[0].device
    outs = [torch.empty((batch, seq_len, out_n, out_d), device=dev)
            for _ in uhats]
    stats = [torch.empty((seq_len, num_iter, batch, in_n, 2), device=dev)
             for _ in uhats]
    valid = _valid_bytes(step_valid)
    err = lib.sdr_tp_fwd_persistent(
        _ptrs(uhats), _ptrs(outs), _ptrs(stats),
        None if v_inits is None else _ptrs(v_inits),
        None if valid is None else valid.data_ptr(), exchange.xbufs,
        exchange.flags, exchange.status.data_ptr(), exchange.ranks, rank0,
        len(uhats), pad_rank, exchange.cap, exchange.epochs,
        int(exchange.timeout_s * 1e9), batch, seq_len, in_n, out_n, out_d,
        num_iter, bf16, stream)
    _persistent_done(lib, "K1-tp", err, exchange, seq_len * num_iter)
    return outs, stats


def tp_backward_persistent(lib, uhats, vss, dvss, statss, pad_rank,
                           exchange, rank0, stream):
    """K2-tp's persistent reverse-time kernel, launched as
    :func:`tp_forward_persistent`: per launched rank its u_hat (bf16: the
    bf16 instance), outputs and their cotangents [B, T, out_n, out_d] and
    the forward's (M, L) [T, 1, B, in_n, 2]. Returns du_hat's factors (c,
    da [B, T, in_n, out_n], ds [B, T, out_n * out_d]) per launched rank, in
    K2's layout."""
    batch, seq_len, in_n = uhats[0].shape[:3]
    out_n, out_d = vss[0].shape[2], vss[0].shape[3]
    bf16 = _is_bf16(uhats[0])
    _check_persistent(lib, "K2-tp", batch, len(uhats), in_n, out_n, out_d,
                      1, bf16)
    dev = uhats[0].device
    cfacs = [torch.empty((batch, seq_len, in_n, out_n), device=dev)
             for _ in uhats]
    dafacs = [torch.empty_like(c) for c in cfacs]
    dsfacs = [torch.empty((batch, seq_len, out_n * out_d), device=dev)
              for _ in uhats]
    err = lib.sdr_tp_bwd_persistent(
        _ptrs(uhats), _ptrs(vss), _ptrs(dvss), _ptrs(statss), _ptrs(cfacs),
        _ptrs(dafacs), _ptrs(dsfacs), exchange.xbufs, exchange.flags,
        exchange.status.data_ptr(), exchange.ranks, rank0, len(uhats),
        pad_rank, exchange.cap, exchange.epochs,
        int(exchange.timeout_s * 1e9), batch, seq_len, in_n, out_n, out_d,
        bf16, stream)
    _persistent_done(lib, "K2-tp", err, exchange, seq_len)
    return list(zip(cfacs, dafacs, dsfacs))


def _gather_pairs(local, group):
    """Every rank's (m, l) pairs, [ranks, ...] in rank order: one
    all-gather over the ``model`` group (c10d on the current stream: NCCL
    or gloo, as the group is). The pairs, not JAX's two all-reduces of the
    max and the sum: one collective a step, the same values up to
    rounding (F24)."""
    from srf_tpu_torch.parallel import distributed

    ranks = distributed.world_size(group) if group is not None else 1
    if ranks == 1:
        return local[None]
    import torch.distributed as dist

    # [ranks * rows, 2]: gloo's all-gather takes the ranks along dim 0
    out = torch.empty((ranks * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=group)
    return out.view((ranks,) + tuple(local.shape))


def _sum_over(x, group):
    """``x`` summed over ``group`` in place (one SUM all-reduce)."""
    from srf_tpu_torch.parallel import distributed

    if group is not None and distributed.world_size(group) > 1:
        import torch.distributed as dist

        dist.all_reduce(x, group=group)
    return x


def _check_tp(fn_name, u, wgt, bias, extra=()):
    """Device, dtype (u, W and bias float32, or all three bf16; the rest
    float32), rank and contiguity of the inputs (``extra`` more of them),
    and u's, W's and bias's shapes agreeing; before any build. Returns 1
    for bf16 inputs (the kernels' bf16 instances), else 0."""
    bf16 = int(bool(_variant(u)))
    _check_inputs(fn_name, u, (("u", u, 4), ("W", wgt, 4), ("bias", bias, 3)),
                  u.dtype)
    _check_inputs(fn_name, u, tuple(extra))
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    if (wgt.shape[0], wgt.shape[3]) != (in_n, in_d) or tuple(bias.shape) != (
            in_n, out_n, out_d):
        raise ValueError("shape mismatch: u %s, W %s, bias %s" % (
            tuple(u.shape), tuple(wgt.shape), tuple(bias.shape)))
    if batch < 1 or seq_len < 1:
        raise ValueError("need B and T >= 1 (got %d, %d)" % (batch, seq_len))
    return bf16


def _check_carry(fn_name, u, wgt, v_init, step_valid):
    """K1-tp-stream's inputs: ``v_init`` [B, O_local, out_d] float32 and
    ``step_valid`` [B, T] bool, each contiguous on u's device, or None."""
    batch, seq_len = u.shape[:2]
    if v_init is not None:
        _check_inputs(fn_name, u, (("v_init", v_init, 3),))
        want = (batch, wgt.shape[1], wgt.shape[2])
        if tuple(v_init.shape) != want:
            raise ValueError("v_init must be %s, got %s"
                             % (want, tuple(v_init.shape)))
    if step_valid is not None and (
            step_valid.device != u.device or not step_valid.is_contiguous()
            or step_valid.dtype != torch.bool
            or tuple(step_valid.shape) != (batch, seq_len)):
        raise ValueError(
            "step_valid must be a contiguous bool %s tensor on %s, got %s %s "
            "on %s" % ((batch, seq_len), u.device, step_valid.dtype,
                       tuple(step_valid.shape), step_valid.device))


def _check_tp_smem(lib, wgt):
    in_n, out_n, out_d = wgt.shape[:3]
    if lib.sdr_tp_smem_bytes(in_n, out_n, out_d) < 0:
        raise ValueError(
            "capsule geometry (in_n, O_local, out_d) = (%d, %d, %d) does not "
            "fit the sdr_tp kernels' shared memory" % (in_n, out_n, out_d))


def _predict_rows(fwd, u, wgt, bias, stream):
    """This rank's u_hat [B, T, in_n, pitch] by the prediction kernel: in
    u's dtype, float32 (pitch a multiple of 4) or bf16 (``sdr_predict_bf16``,
    pitch a multiple of 8: 16 bytes either way)."""
    batch, seq_len, in_n, in_d = u.shape
    out_no = wgt.shape[1] * wgt.shape[2]
    uhat = torch.empty((batch, seq_len, in_n,
                        _plain().row_pitch(out_no, u.dtype.itemsize)),
                       dtype=u.dtype, device=u.device)
    name = "sdr_predict" + _variant(u)
    _raise_on(fwd, "sdr_fwd", getattr(fwd, name)(
        u.data_ptr(), wgt.data_ptr(), bias.data_ptr(), uhat.data_ptr(),
        batch * seq_len, in_n, in_d, out_no, stream))
    _count_predict(wgt)
    return uhat


def _ipc_set(group, rows, device, pad_owner):
    """(exchange, this rank, the PAD capsule's rank or -1) of this rank's
    persistent launch over transport 2."""
    from srf_tpu_torch.parallel import distributed

    me = distributed.rank(group)
    return (ipc_exchange(group, rows, device), me,
            me if pad_owner else -1)


def _fwd_variant(bf16, v_init, step_valid):
    """The counter a K1-tp call adds its launches to: "_bf16" (K1-tp-bf16),
    "_stream" (K1-tp-stream: a carry or a step mask) or "" (K1-tp)."""
    if bf16:
        return "_bf16"
    return "_stream" if v_init is not None or step_valid is not None else ""


def sequential_routing_tp_cuda(u, wgt, bias, num_iter, pad_owner, group,
                               v_init=None, step_valid=None):
    """SDR on a shard of the out capsules on the card (K1-tp): same
    contract as ``ops.routing.sequential_routing_tp(..., return_stats=
    True)``. u [B, T, in_n, in_d] (replicated over ``group``), this rank's
    wgt [in_n, O_local, out_d, in_d] and bias [in_n, O_local, out_d],
    float32, contiguous, on one CUDA device -> (out [B, T, O_local, out_d],
    the global (M, L) [T, num_iter, B, in_n, 2]), float32. Given bf16 u, W
    and bias, K1-tp-bf16 computes ``sequential_routing_tp(..., bf16=True)``.
    ``v_init`` [B, O_local, out_d] float32 (the carry before step 0) and
    ``step_valid`` [B, T] bool (K1-tp-stream), contiguous on u's device, or
    None. One exchange a step and iteration over ``group``, by the group's
    transport (:func:`tp_transport`): the persistent kernel over CUDA IPC,
    or the host loop's all-gather of the rows' (m, l) pairs (``group``
    None: no exchange). Raises on anything the kernels do not take; never
    falls back to the plain version or to another transport.
    ``sequential_routing_tp_cuda.launches`` (``launches_bf16``,
    ``launches_stream``) counts K1-tp's (K1-tp-bf16's, K1-tp-stream's)
    kernel launches (the prediction, then one persistent launch, or two a
    step and iteration), ``.launches_persistent`` those of the persistent
    transports, every variant's."""
    name = "sequential_routing_tp_cuda"
    bf16 = _check_tp(name, u, wgt, bias)
    _check_carry(name, u, wgt, v_init, step_valid)
    if num_iter < 1:
        raise ValueError("need num_iter >= 1 (got %d)" % num_iter)
    lib, fwd, _ = _tp_libs()
    batch, seq_len, in_n = u.shape[:3]
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if tp_transport(group) == "host_loop":
            _check_tp_smem(lib, wgt)
            uhat = _predict_rows(fwd, u, wgt, bias, stream)
            out, stats = drive(
                tp_forward_steps(lib, uhat, out_n, out_d, num_iter,
                                 pad_owner, stream, v_init, step_valid),
                lambda local: _gather_pairs(local, group))
            launches = 1 + 2 * seq_len * num_iter
        else:
            exchange, me, pad_rank = _ipc_set(group, batch * in_n, u.device,
                                              pad_owner)
            _check_persistent(lib, "K1-tp", batch, 1, in_n, out_n, out_d, 0,
                              bf16)
            uhat = _predict_rows(fwd, u, wgt, bias, stream)
            (out,), (stats,) = tp_forward_persistent(
                lib, [uhat], out_n, out_d, num_iter, pad_rank, exchange, me,
                stream, None if v_init is None else [v_init], step_valid)
            launches = 2
            sequential_routing_tp_cuda.launches_persistent += launches
    counter = "launches" + _fwd_variant(bf16, v_init, step_valid)
    setattr(sequential_routing_tp_cuda, counter,
            getattr(sequential_routing_tp_cuda, counter) + launches)
    return out, stats


sequential_routing_tp_cuda.launches = 0
sequential_routing_tp_cuda.launches_bf16 = 0
sequential_routing_tp_cuda.launches_stream = 0
sequential_routing_tp_cuda.launches_persistent = 0


def sequential_routing_tp_stream(u, wgt, bias, num_iter, pad_owner, group,
                                 v_init=None, step_valid=None):
    """SDR forward on a shard of the out capsules with an initial carry and
    a per-step mask: a sharded model's streaming block (``models/srf.py``
    ``route_block``), the counterpart of JAX's ``route_block`` on a
    ``model`` mesh. ``v_init`` [B, O_local, out_d] (this rank's part of the
    carry) or None (zeros); ``step_valid`` [T] or [B, T] bool or None
    (every step valid). A CUDA tensor goes to K1-tp-stream
    (:func:`sequential_routing_tp_cuda` with both inputs), a CPU tensor to
    the plain ``sequential_routing_tp``; nothing else decides. Returns this
    rank's outputs [B, T, O_local, out_d], float32. Forward only, as
    :func:`sequential_routing_stream`."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (u, wgt, bias, v_init)):
        raise RuntimeError(
            "sequential_routing_tp_stream is forward-only; call it under "
            "torch.no_grad() or torch.inference_mode()")
    if step_valid is not None:
        step_valid = torch.as_tensor(step_valid, device=u.device)
        if step_valid.dim() == 1:
            step_valid = step_valid.expand(u.shape[0], -1)
    if not u.is_cuda:
        return _plain().sequential_routing_tp(
            u, wgt, bias, num_iter, pad_owner, group, v_init=v_init,
            step_valid=step_valid)
    cd = _plain()._compute_dtype(u.dtype)
    return sequential_routing_tp_cuda(
        *(x.to(cd).contiguous() for x in (u, wgt, bias)), num_iter,
        pad_owner, group,
        None if v_init is None else v_init.to(cd).contiguous(),
        None if step_valid is None else step_valid.contiguous())[0]


def _check_tp_grads(name, u, wgt, bias, vs, dvs, stats):
    """The backward's inputs: u, W and bias as :func:`_check_tp`, vs and dvs
    [B, T, O_local, out_d], the one-iteration forward's stats. Returns 1
    for bf16 u, W and bias."""
    bf16 = _check_tp(name, u, wgt, bias,
                     (("vs", vs, 4), ("dvs", dvs, 4), ("stats", stats, 5)))
    batch, seq_len, in_n = u.shape[:3]
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    for label, x in (("vs", vs), ("dvs", dvs)):
        if tuple(x.shape) != (batch, seq_len, out_n, out_d):
            raise ValueError("%s must be %s, got %s" % (
                label, (batch, seq_len, out_n, out_d), tuple(x.shape)))
    if tuple(stats.shape) != (seq_len, 1, batch, in_n, 2):
        # K2-tp is the one-iteration backward: a deeper forward's stats
        # would pass for its first iteration and give a wrong gradient
        raise ValueError("stats must be a one-iteration forward's [%d, 1, "
                         "%d, %d, 2], got %s"
                         % (seq_len, batch, in_n, tuple(stats.shape)))
    return bf16


def _weight_grads(bwd, u, wgt, vs, cfac, dafac, dsfac, stream):
    """(this rank's part of du, the shard's dW and db) from du_hat's
    factors: K2's weight-gradient kernel and its reduction (their bf16
    instance on bf16 u and W), float32 sums."""
    batch, seq_len, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    name = "sdr_bwd_wgrad" + _variant(u)
    floats = getattr(bwd, name + "_part_floats")(batch, seq_len, in_n, in_d,
                                                 out_n, out_d)
    if floats < 0:
        raise RuntimeError("%s: no weight-gradient plan for %s on %s"
                           % (name, tuple(wgt.shape), u.device))
    part = torch.empty(floats, device=u.device)
    du = torch.empty(u.shape, device=u.device)
    dwgt = torch.empty(wgt.shape, device=u.device)
    dbias = torch.empty(wgt.shape[:3], device=u.device)
    _raise_on(bwd, "sdr_bwd", getattr(bwd, name)(
        u.data_ptr(), wgt.data_ptr(), vs.data_ptr(), cfac.data_ptr(),
        dafac.data_ptr(), dsfac.data_ptr(), part.data_ptr(), du.data_ptr(),
        dwgt.data_ptr(), dbias.data_ptr(), batch, seq_len, in_n, in_d, out_n,
        out_d, stream))
    _count_wgrad(wgt)
    return du, dwgt, dbias


def _rounded(grad, bf16):
    """A gradient as the bf16 instances return it (its float32 sum rounded
    once), or as it is."""
    return grad.to(torch.bfloat16) if bf16 else grad


def sequential_routing_tp_bwd_cuda(u, wgt, bias, vs, dvs, stats, pad_owner,
                                   group):
    """K1-tp's backward on the card (K2-tp), one routing iteration: same
    contract as ``ops.routing.sequential_routing_tp_bwd``. u, this rank's
    wgt and bias, its outputs vs and their cotangent dvs [B, T, O_local,
    out_d], the forward's ``stats``, float32, contiguous, on one CUDA
    device -> (du, dW, db): du the whole gradient of u (summed over
    ``group`` once, after the loop), dW and db the shard's. Given bf16 u,
    W and bias (vs, dvs and stats float32: K1-tp-bf16's), K2-tp-bf16
    computes ``sequential_routing_tp_bwd_bf16``: (du, dW, db) in bf16, each
    a float32 sum (du's over the group too) rounded once. One exchange of
    the rows' [B, in_n] sums a step over ``group``, by the group's
    transport (as :func:`sequential_routing_tp_cuda`). Raises on anything
    the kernels do not take; never falls back to the plain version or to
    another transport. ``sequential_routing_tp_bwd_cuda.launches``
    (``launches_bf16``) counts K2-tp's (K2-tp-bf16's) kernel launches: the
    prediction, one persistent launch (or two a step), the weight gradient
    and its reduction; ``.launches_persistent`` those of the persistent
    transports."""
    bf16 = _check_tp_grads("sequential_routing_tp_bwd_cuda", u, wgt, bias,
                           vs, dvs, stats)
    lib, fwd, bwd = _tp_libs()
    batch, seq_len, in_n = u.shape[:3]
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if tp_transport(group) == "host_loop":
            _check_tp_smem(lib, wgt)
            uhat = _predict_rows(fwd, u, wgt, bias, stream)
            cfac, dafac, dsfac = drive(
                tp_backward_steps(lib, uhat, vs, dvs, stats, pad_owner,
                                  stream),
                lambda rowsum: _sum_over(rowsum, group))
            launches = 1 + 2 * seq_len + 2
        else:
            exchange, me, pad_rank = _ipc_set(group, batch * in_n, u.device,
                                              pad_owner)
            _check_persistent(lib, "K2-tp", batch, 1, in_n, out_n, out_d, 1,
                              bf16)
            uhat = _predict_rows(fwd, u, wgt, bias, stream)
            (cfac, dafac, dsfac), = tp_backward_persistent(
                lib, [uhat], [vs], [dvs], [stats], pad_rank, exchange, me,
                stream)
            launches = 4
            sequential_routing_tp_bwd_cuda.launches_persistent += launches
        du, dwgt, dbias = _weight_grads(bwd, u, wgt, vs, cfac, dafac, dsfac,
                                        stream)
        _sum_over(du, group)
    if bf16:
        sequential_routing_tp_bwd_cuda.launches_bf16 += launches
    else:
        sequential_routing_tp_bwd_cuda.launches += launches
    return tuple(_rounded(g, bf16) for g in (du, dwgt, dbias))


sequential_routing_tp_bwd_cuda.launches = 0
sequential_routing_tp_bwd_cuda.launches_bf16 = 0
sequential_routing_tp_bwd_cuda.launches_persistent = 0


def _check_colaunch(name, u, wgts, *per_shard):
    """Every shard as :func:`_check_tp` (W, then bias, then the lists of
    ``per_shard``, one entry a shard), the shards of one shape, at most
    TP_MAX_RANKS of them. Returns 1 for bf16 u, W and bias."""
    if not 1 <= len(wgts) <= TP_MAX_RANKS or any(
            len(xs) != len(wgts) for xs in per_shard):
        raise ValueError("%s takes 1 to %d shards, an entry a shard in "
                         "each list, got %s" % (name, TP_MAX_RANKS, [
                             len(wgts)] + [len(xs) for xs in per_shard]))
    for q, wgt in enumerate(wgts):
        bf16 = _check_tp(name, u, wgt, per_shard[0][q])
        if wgt.shape != wgts[0].shape:
            raise ValueError("%s: shard %d's W is %s, shard 0's %s" % (
                name, q, tuple(wgt.shape), tuple(wgts[0].shape)))
    return bf16


def sequential_routing_tp_colaunch_cuda(u, wgts, biases, num_iter, pad,
                                        v_inits=None, step_valid=None):
    """K1-tp for every rank's shard in this process and one launch on one
    card (the co-launch transport): u [B, T, in_n, in_d], ``wgts`` and
    ``biases`` the ranks' shards in rank order (equal shapes), ``pad``: the
    layer masks the PAD capsule, which rank 0's shard holds; bf16 u, W and
    bias: K1-tp-bf16; ``v_inits`` (each shard's carry before step 0) and
    ``step_valid`` [B, T] bool, or None: K1-tp-stream. Returns ([out_r],
    [stats_r]), each what ``sequential_routing_tp_cuda`` returns on rank r
    of a group of len(wgts); the plain version is
    ``ops.routing.sequential_routing_tp_colaunch``.
    ``sequential_routing_tp_colaunch_cuda.launches`` (``launches_bf16``,
    ``launches_stream``) counts its launches: one prediction a shard and
    one persistent launch."""
    name = "sequential_routing_tp_colaunch_cuda"
    bf16 = _check_colaunch(name, u, wgts, biases)
    for q, wgt in enumerate(wgts):
        _check_carry(name, u, wgt, None if v_inits is None else v_inits[q],
                     step_valid)
    if num_iter < 1:
        raise ValueError("need num_iter >= 1 (got %d)" % num_iter)
    lib, fwd, _ = _tp_libs()
    batch, seq_len, in_n = u.shape[:3]
    out_n, out_d = wgts[0].shape[1], wgts[0].shape[2]
    _check_persistent(lib, "K1-tp", batch, len(wgts), in_n, out_n, out_d, 0,
                      bf16)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        uhats = [_predict_rows(fwd, u, w, b, stream)
                 for w, b in zip(wgts, biases)]
        outs, stats = tp_forward_persistent(
            lib, uhats, out_n, out_d, num_iter, 0 if pad else -1,
            local_exchange(len(wgts), batch * in_n, u.device), 0, stream,
            v_inits, step_valid)
    fn = sequential_routing_tp_colaunch_cuda
    counter = "launches" + _fwd_variant(bf16, v_inits, step_valid)
    setattr(fn, counter, getattr(fn, counter) + len(wgts) + 1)
    return outs, stats


sequential_routing_tp_colaunch_cuda.launches = 0
sequential_routing_tp_colaunch_cuda.launches_bf16 = 0
sequential_routing_tp_colaunch_cuda.launches_stream = 0


def sequential_routing_tp_bwd_colaunch_cuda(u, wgts, biases, vss, dvss,
                                            statss, pad):
    """K2-tp for every rank's shard in this process and one launch (the
    co-launch transport), one routing iteration: u, the shards as
    :func:`sequential_routing_tp_colaunch_cuda`, each shard's outputs
    ``vss``, their cotangents ``dvss`` and the forward's (M, L) ``statss``
    in rank order -> (du summed over the shards in rank order, [dW_r],
    [db_r]); bf16 u, W and bias: K2-tp-bf16, each gradient a float32 sum
    rounded to bf16 once. The plain version is
    ``ops.routing.sequential_routing_tp_bwd_colaunch``.
    ``sequential_routing_tp_bwd_colaunch_cuda.launches``
    (``launches_bf16``) counts its launches: a prediction a shard, one
    persistent launch, and the weight gradient and its reduction a
    shard."""
    name = "sequential_routing_tp_bwd_colaunch_cuda"
    bf16 = _check_colaunch(name, u, wgts, biases, vss, dvss, statss)
    for wgt, bias, vs, dvs, stats in zip(wgts, biases, vss, dvss, statss):
        _check_tp_grads(name, u, wgt, bias, vs, dvs, stats)
    lib, fwd, bwd = _tp_libs()
    batch, seq_len, in_n = u.shape[:3]
    out_n, out_d = wgts[0].shape[1], wgts[0].shape[2]
    _check_persistent(lib, "K2-tp", batch, len(wgts), in_n, out_n, out_d, 1,
                      bf16)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        uhats = [_predict_rows(fwd, u, w, b, stream)
                 for w, b in zip(wgts, biases)]
        factors = tp_backward_persistent(
            lib, uhats, vss, dvss, statss, 0 if pad else -1,
            local_exchange(len(wgts), batch * in_n, u.device), 0, stream)
        grads = [_weight_grads(bwd, u, w, vs, *f, stream)
                 for w, vs, f in zip(wgts, vss, factors)]
    dus, dwgts, dbiases = zip(*grads)
    du = dus[0]
    for part in dus[1:]:
        du = du + part
    fn = sequential_routing_tp_bwd_colaunch_cuda
    counter = "launches_bf16" if bf16 else "launches"
    setattr(fn, counter, getattr(fn, counter) + 3 * len(wgts) + 1)
    return (_rounded(du, bf16), [_rounded(g, bf16) for g in dwgts],
            [_rounded(g, bf16) for g in dbiases])


sequential_routing_tp_bwd_colaunch_cuda.launches = 0
sequential_routing_tp_bwd_colaunch_cuda.launches_bf16 = 0


class SDRTPFunction(torch.autograd.Function):
    """SDR on a shard of the out capsules, the softmax split over the
    ``model`` group (``ops/routing.py:sequential_routing_tp``): the
    counterpart of the loop body XLA partitions when W and b are sharded
    on dim 1 (``srf_tpu/ops/routing.py:_sdr_step_factored``; no Pallas
    kernel).

    forward: u, W and bias cast to float32 (float64 stays, for the CPU
    tests), or to bf16 with ``bf16`` (bf16 routing); K1-tp (K1-tp-bf16) on
    a CUDA tensor (:func:`sequential_routing_tp_cuda`), the plain
    ``sequential_routing_tp`` on a CPU tensor. Saves u, W, bias, the
    float32 output and the global (M, L) of every step and iteration.
    backward: with one routing iteration K2-tp (K2-tp-bf16) on CUDA
    (:func:`sequential_routing_tp_bwd_cuda`) and the plain
    ``sequential_routing_tp_bwd`` (``sequential_routing_tp_bwd_bf16``) on
    the CPU, the float32 ones from the saved (M, L); with more, autograd
    through the plain split loop recomputed from the saved inputs, counted
    in ``SDRTPFunction.plain_backwards`` (as ``SDRFunction``'s). u's
    gradient is the whole one, summed over the group; W's and bias's are
    the shard's; each is cast to its input's dtype. Only the device,
    ``bf16`` and ``num_iter`` choose; nothing falls back on failure.
    """

    plain_backwards = 0

    @staticmethod
    def forward(ctx, u, wgt, bias, num_iter, pad_owner, group, bf16=False):
        ctx.dtypes = (u.dtype, wgt.dtype, bias.dtype)
        cd = torch.bfloat16 if bf16 else _plain()._compute_dtype(u.dtype)
        u, wgt, bias = (x.to(cd).contiguous() for x in (u, wgt, bias))
        if u.is_cuda:
            out, stats = sequential_routing_tp_cuda(u, wgt, bias, num_iter,
                                                    pad_owner, group)
        else:
            out, stats = _plain().sequential_routing_tp(
                u, wgt, bias, num_iter, pad_owner, group, return_stats=True,
                bf16=bf16)
        ctx.save_for_backward(u, wgt, bias, out, stats)
        ctx.num_iter, ctx.pad_owner, ctx.group = num_iter, pad_owner, group
        ctx.bf16 = bf16
        return out.to(ctx.dtypes[0])

    @staticmethod
    def backward(ctx, dout):
        u, wgt, bias, out, stats = ctx.saved_tensors
        dout = dout.to(out.dtype).contiguous()
        if ctx.num_iter == 1 and u.is_cuda:
            grads = sequential_routing_tp_bwd_cuda(
                u, wgt, bias, out, dout, stats, ctx.pad_owner, ctx.group)
        elif ctx.bf16:
            SDRTPFunction.plain_backwards += ctx.num_iter > 1
            grads = _plain().sequential_routing_tp_bwd_bf16(
                u, wgt, bias, dout, ctx.pad_owner, ctx.group, ctx.num_iter)
        elif ctx.num_iter == 1:
            grads = _plain().sequential_routing_tp_bwd(
                u, wgt, bias, out, dout, ctx.pad_owner, ctx.group, stats)
        else:
            SDRTPFunction.plain_backwards += 1
            with torch.enable_grad():
                inputs = [x.detach().requires_grad_() for x in (u, wgt, bias)]
                recomputed = _plain().sequential_routing_tp(
                    *inputs, ctx.num_iter, ctx.pad_owner, ctx.group)
                grads = torch.autograd.grad(recomputed, inputs, dout)
        return (*(g.to(d) for g, d in zip(grads, ctx.dtypes)), None, None,
                None, None)


def _plain_loop_grads(u, wgt, bias, ctx, dout):
    """(du, dW, db) by autograd through the plain loop recomputed from the
    saved inputs: the backward of more than one routing iteration."""
    if getattr(ctx, "bf16", False):
        return _plain().sequential_routing_bwd_bf16(
            u, wgt, bias, dout, ctx.mask_pad_capsule, ctx.num_iter)
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
