"""Dynamic routing cores (port of ``srf_tpu/ops/routing.py``).

- **DR** (``--model-caps-context=False``): all timesteps routed in parallel
  (reference math: sequence_router_naive.py:200-206). Plain PyTorch on
  every device; the JAX package had no TPU kernel for it either.
- **SDR** (``--model-caps-context=True``): a recurrence over time whose
  carry is the previous timestep's output capsules
  (reference math: sequence_router_naive.py:213-245).
  :func:`sequential_routing` is its plain PyTorch version, a Python loop
  over T, and :func:`sequential_routing_bwd` the plain version of its
  fused backward; each is composed of the plain versions of the kernels'
  parts (:func:`predict_capsules_rows`, :func:`sequential_routing_from_uhat`,
  :func:`sequential_routing_bwd_factors`, :func:`sdr_weight_grads`).
  :func:`route_layer` sends SDR through
  ``ops/routing_cuda.SDRFunction``: on a CUDA tensor its forward is the
  hand-written kernel K1 (``sequential_routing_cuda``, replacing the TPU
  kernel ``srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel``) and its
  backward K2 (``sequential_routing_bwd_cuda``, replacing
  ``_sdr_bwd_kernel``); on a CPU tensor it runs the plain versions. The
  same function through K3 and K4, the cluster-scan kernels, is
  ``routing_cuda.sequential_routing_scan`` (the counterpart of
  ``sequential_routing_pallas_scan``), which no model calls; their order
  of sums is :func:`sequential_routing_scan_partitioned` and
  :func:`sequential_routing_scan_bwd_partitioned`. Streaming's SDR, with
  an initial carry and a per-step mask, is
  ``routing_cuda.sequential_routing_stream`` (K1 on a CUDA tensor, the
  plain :func:`sequential_routing` on a CPU tensor), over the windows of
  :func:`window_slide`.
- PAD-capsule masking: at the last capsule layer the routing logit of
  output capsule 0 (the PAD class) gets -1e9 so nothing routes to it
  (reference: sequence_router_naive.py:174-178,219-220).
- The wavefront (``--tpu-routing-kernel=wavefront``,
  :func:`wavefront_sdr_stack`): the whole SDR stack, each layer's
  LayerNorm and dropout included, as one loop over time, each layer
  staggered by rpad + 1 steps behind the one below it; plain PyTorch on
  every device, as JAX's is a ``lax.scan`` of XLA ops with no Pallas
  kernel. It routes without u_hat (:func:`_sdr_step_factored`, JAX's
  default); with one layer it is that layer's SDR (K1 and K2 on the card).
- bf16 routing (``--tpu-routing-bf16``, ``bf16=True``): JAX's SDR with
  ``compute_dtype=bfloat16`` in its materialized scan body (``impl="xla"``,
  ``srf_tpu/ops/routing.py:_sdr_step``): u_hat = bf16(bf16(W u) + b) from
  bf16 W, u and b, each agreement <u_hat, bf16(v)> and each sum
  bf16(c) u_hat taken in float32, the logits, softmax, squash and carried v
  in float32. Its backward is autograd through that loop
  (:func:`sequential_routing_bwd_bf16`), whose casts round every cotangent
  of a bf16 value to bf16; the kernels' bf16 variants follow both (F19 and
  F20 in ROADMAP.md record where JAX's ``auto`` path and JAX's transposed
  scan round elsewhere).

- The ``model`` mesh axis (``parallel/sharding_rules.apply_rules``): a
  layer whose out capsules are split over the ``model`` ranks routes with
  a softmax split across them. :func:`sequential_routing_tp` is JAX's
  partitioned SDR step, one step at a time (what XLA makes of
  ``route_layer`` with W and b sharded on dim 1): the local agreement, the
  PAD mask only on the rank that holds global capsule 0, the global row
  max (a MAX all-reduce, detached: a softmax does not depend on its
  shift), the global row sum of exp(b - M) (a differentiable SUM
  all-reduce), the local c, s and squash; the carry stays local. Its
  input u is replicated, so it enters through
  ``distributed.copy_to_group``. :func:`sequential_routing_tp_bwd` is the
  plain one-iteration backward (one SUM all-reduce of a row's
  sum_o c dc a step, du summed over the ranks once); both are the plain
  versions of K1-tp and K2-tp (``routing_cuda.SDRTPFunction``). With
  ``bf16`` they are bf16 routing's on a shard (K1-tp-bf16; its backward
  :func:`sequential_routing_tp_bwd_bf16`, K2-tp-bf16's), and with
  ``v_init`` and ``step_valid`` streaming's (K1-tp-stream).
  :func:`dynamic_routing` with a ``group`` is DR with the same split, and
  :func:`wavefront_sdr_stack` with ``shards`` the wavefront's.

Shapes (the JAX layouts):
    u      [B, T, in_n, in_d]      input capsules (after windowing)
    W      [in_n, out_n, out_d, in_d]
    bias   [in_n, out_n, out_d]
    v      [B, T, out_n, out_d]    output capsules
"""

import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from srf_tpu_torch.ops.routing_cuda import SDRFunction, SDRTPFunction
from srf_tpu_torch.ops.squash import squash
from srf_tpu_torch.parallel import distributed

NEG_INF = -1e9


def window_stack(u, lpad, rpad):
    """Contextual windowing: concat shifted copies along the capsule axis.

    [B, T, n, d] -> [B, T, (lpad+rpad+1)*n, d]; copy i is the input
    zero-padded (lpad, rpad) in time then sliced [i : i+T]
    (reference: sequence_router_naive.py:150-151).
    """
    window = lpad + rpad + 1
    if window == 1:
        return u
    seq_len = u.shape[1]
    padded = F.pad(u, (0, 0, 0, 0, lpad, rpad))
    return torch.cat([padded[:, i : i + seq_len] for i in range(window)], dim=2)


def window_slide(u, lpad, rpad):
    """Sliding windows without edge padding: [B, T, n, d] ->
    [B, T-lpad-rpad, (lpad+rpad+1)*n, d], in :func:`window_stack`'s
    frame-major capsule order. Streaming's windowing, where the context
    frames come from carried buffers instead of zero padding."""
    window = lpad + rpad + 1
    if window == 1:
        return u
    out_len = u.shape[1] - lpad - rpad
    return torch.cat([u[:, i : i + out_len] for i in range(window)], dim=2)


def predict_capsules(u, wgt, bias):
    """u_hat = W·u + b for every timestep: [B, T, in_n, out_n, out_d]."""
    return torch.einsum("noij,btnj->btnoi", wgt, u) + bias[None, None]


def _pad_capsule_mask(out_n, dtype, device):
    """[out_n] vector: -1e9 at index 0 (the PAD class), 0 elsewhere."""
    mask = torch.zeros(out_n, dtype=dtype, device=device)
    mask[0] = NEG_INF
    return mask


def dynamic_routing(u_hat, num_iter, mask_pad_capsule, group=None):
    """DR: route all timesteps in parallel.

    Per iteration (reference: sequence_router_naive.py:200-206):
        b += pad_mask ; c = softmax(b, out) ; s = sum_in(c * u_hat)
        v = squash(s) ; b += <u_hat, v>

    With ``group`` (the ``model`` ranks), ``u_hat`` [B, T, in_n, O_local,
    out_d] is this rank's shard of the out capsules (from a u that entered
    through ``copy_to_group``) and the softmax is split across ``group``
    (the :func:`sequential_routing_tp` split, once an iteration over every
    frame); ``mask_pad_capsule`` then means the shard holds global capsule
    0 on the last layer.
    """
    batch, seq_len, in_n, out_n, _ = u_hat.shape
    b = torch.zeros((batch, seq_len, in_n, out_n), dtype=u_hat.dtype,
                    device=u_hat.device)
    pad_mask = (_pad_capsule_mask(out_n, u_hat.dtype, u_hat.device)
                if mask_pad_capsule else None)
    v = None
    for _ in range(num_iter):
        if pad_mask is not None:
            b = b + pad_mask
        c = _split_softmax(b, group)[0]
        s = torch.einsum("btno,btnoi->btoi", c, u_hat)
        v = squash(s, dim=-1)
        b = b + torch.einsum("btnoi,btoi->btno", u_hat, v)
    return v


def _compute_dtype(dtype):
    """float32 for float32 and narrower inputs, float64 for float64 (so
    ``gradcheck`` can hold the routing in double precision)."""
    return torch.promote_types(dtype, torch.float32)


def round_bf16(x):
    """``x`` rounded to bf16 and widened back to its dtype (the value a
    bf16 product takes)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _sdr_step(u_hat_t, v_prev, num_iter, pad_mask, bf16=False):
    """One SDR timestep given u_hat_t [B, in_n, out_n, out_d].

    Routing logits accumulate agreement with v across the iterations; the
    first agreement term uses the *previous timestep's* output capsules
    (reference: sequence_router_naive.py:222-227). ``bf16``: u_hat_t is
    bf16, and the products take bf16(v) and bf16(c) in float32, as JAX's
    ``_sdr_step`` with a bf16 u_hat_t.
    """
    if bf16:
        # one widening copy, so that its cotangent is summed in float32
        # over the step's two products and rounded to bf16 once
        u_hat_t = u_hat_t.float()
    b = torch.zeros(u_hat_t.shape[:3], dtype=u_hat_t.dtype,
                    device=u_hat_t.device)  # [B, in_n, out_n]
    v = v_prev
    for _ in range(num_iter):
        b = b + torch.einsum("bnoi,boi->bno", u_hat_t,
                             round_bf16(v) if bf16 else v)
        if pad_mask is not None:
            b = b + pad_mask
        c = torch.softmax(b, dim=2)
        s = torch.einsum("bno,bnoi->boi", round_bf16(c) if bf16 else c,
                         u_hat_t)
        v = squash(s, dim=-1)
    return v


def row_pitch(out_no, esize=4):
    """Entries per in-capsule row of u_hat in the kernels' layout: out_n *
    out_d rounded up to 16 bytes of ``esize``-byte entries (4 floats, or 8
    bf16: a bulk copy moves 16-byte multiples)."""
    per16 = 16 // esize
    return -(-out_no // per16) * per16


def predict_capsules_bf16(u, wgt, bias):
    """The bf16 prediction vectors [B, T, in_n, out_n, out_d] from bf16
    ``u``, ``wgt`` and ``bias``: bf16(bf16(W u) + b), the product summed in
    float32 (JAX's einsum with ``preferred_element_type`` bf16, then a bf16
    add)."""
    return (torch.einsum("noij,btnj->btnoi", wgt.float(), u.float())
            .to(torch.bfloat16) + bias[None, None])


def predict_capsules_rows(u, wgt, bias):
    """The plain version of the prediction kernel (``csrc/sdr_stream.cuh``):
    :func:`predict_capsules` in the layout K1 and K2 stream, [B, T, in_n,
    P] with each in-capsule row's out_n * out_d entries zero-padded to
    P = ``row_pitch(out_n * out_d)``; on bf16 inputs (the kernel's bf16
    instance) :func:`predict_capsules_bf16`, bf16, P a multiple of 8."""
    batch, seq_len, in_n = u.shape[:3]
    out_no = wgt.shape[1] * wgt.shape[2]
    predict = (predict_capsules_bf16 if u.dtype == torch.bfloat16
               else predict_capsules)
    u_hat = predict(u, wgt, bias).reshape(batch, seq_len, in_n, out_no)
    return F.pad(u_hat, (0, row_pitch(out_no, u.dtype.itemsize) - out_no))


def sequential_routing(u, wgt, bias, num_iter, mask_pad_capsule,
                       v_init=None, step_valid=None, bf16=False):
    """SDR, plain PyTorch: a loop over time carrying the previous outputs.

    The plain version of the K1 and K3 kernels (``routing_cuda``): the tests
    hold it to the JAX scans on the CPU, and the card holds the kernels to it.
    ``u`` is [B, T, in_n, in_d]; u_hat is predicted for every step at once
    (it does not depend on the carry), then routed by
    :func:`sequential_routing_from_uhat`. Returns [B, T, out_n, out_d].

    ``v_init``: initial carry [B, out_n, out_d] (streaming: the previous
    chunk's last output capsules); defaults to zeros (reference: v0 = 0,
    sequence_router_lowmemory.py:169).

    ``step_valid``: optional [T] or [B, T] bool (a row of its own per
    utterance: a streaming pool's slots warm up apart); invalid steps
    contribute zero output AND a zero carry (streaming warm-up frames before
    t=0, which the batch implementation realizes as window zero padding).

    ``bf16``: bf16 routing (the module docstring): the plain version of the
    K1 kernel's bf16 variant; u, W and bias are rounded to bf16 first.
    """
    out_dtype = u.dtype
    if bf16:
        u_hat = predict_capsules_bf16(*(x.to(torch.bfloat16)
                                        for x in (u, wgt, bias)))
    else:
        dtype = _compute_dtype(u.dtype)
        u_hat = predict_capsules(u.to(dtype), wgt.to(dtype), bias.to(dtype))
    return sequential_routing_from_uhat(u_hat, num_iter, mask_pad_capsule,
                                        v_init, step_valid,
                                        bf16).to(out_dtype)


def sequential_routing_from_uhat(u_hat, num_iter, mask_pad_capsule,
                                 v_init=None, step_valid=None, bf16=False):
    """The SDR recurrence from given prediction vectors u_hat [B, T, in_n,
    out_n, out_d]: the plain version of K1's recurrence kernel. ``v_init``
    and ``step_valid`` as in :func:`sequential_routing`. Returns [B, T,
    out_n, out_d] in u_hat's dtype, float32 for a bf16 u_hat (``bf16``).
    ``sequential_routing_from_uhat.cuda_calls`` counts its calls on CUDA
    tensors: the card's model paths never take this loop (a kernel does),
    only the kernels' checks."""
    if u_hat.is_cuda:
        sequential_routing_from_uhat.cuda_calls += 1
    batch, seq_len, _, out_n, out_d = u_hat.shape
    dtype = torch.float32 if bf16 else u_hat.dtype
    pad_mask = (_pad_capsule_mask(out_n, dtype, u_hat.device)
                if mask_pad_capsule else None)
    if v_init is None:
        v = torch.zeros((batch, out_n, out_d), dtype=dtype,
                        device=u_hat.device)
    else:
        v = v_init.to(dtype)
    if step_valid is not None:
        step_valid = torch.as_tensor(step_valid, device=u_hat.device)
        step_valid = step_valid.expand(batch, seq_len)[:, :, None, None]
    outs = []
    for t in range(seq_len):
        v = _sdr_step(u_hat[:, t], v, num_iter, pad_mask, bf16)
        if step_valid is not None:
            v = torch.where(step_valid[:, t], v, 0.0)
        outs.append(v)
    return torch.stack(outs, dim=1)


sequential_routing_from_uhat.cuda_calls = 0


def sequential_routing_bwd(u, wgt, bias, vs, dvs, mask_pad_capsule):
    """The fused SDR backward for one routing iteration, plain PyTorch.

    The plain version of the K2 and K4 kernels (``routing_cuda``), with the
    math of ``srf_tpu/ops/routing_pallas.py:_sdr_bwd_kernel``, in K2's three
    parts: predict u_hat (:func:`predict_capsules`), walk time backwards
    for du_hat's factors (:func:`sequential_routing_bwd_factors`), and form
    du, dW and db from them (:func:`sdr_weight_grads`).

    u [B, T, in_n, in_d], wgt [in_n, out_n, out_d, in_d], bias
    [in_n, out_n, out_d], vs and dvs [B, T, out_n, out_d] ->
    (du, dW, db) in the shapes of u, wgt and bias. Any floating dtype.
    """
    out_dtypes = (u.dtype, wgt.dtype, bias.dtype)
    dtype = _compute_dtype(u.dtype)
    u, wgt, bias = u.to(dtype), wgt.to(dtype), bias.to(dtype)
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    vs = vs.to(dtype).reshape(vs.shape[0], vs.shape[1], out_n, out_d)
    dvs = dvs.to(dtype).reshape(vs.shape)
    u_hat = predict_capsules(u, wgt, bias)
    c, da, ds = sequential_routing_bwd_factors(u_hat, vs, dvs,
                                               mask_pad_capsule)
    grads = sdr_weight_grads(u, wgt, vs, c, da, ds)
    return tuple(x.to(d) for x, d in zip(grads, out_dtypes))


def sequential_routing_bwd_bf16(u, wgt, bias, dvs, mask_pad_capsule,
                                num_iter=1):
    """The bf16 SDR backward, plain: autograd through
    ``sequential_routing(..., bf16=True)``'s loop on bf16 leaves, the plain
    version of the K2 kernel's bf16 variant (one routing iteration there).
    u, wgt and bias bf16, dvs the cotangent of the float32 output ->
    (du, dW, db), bf16: each the float32 sum rounded once, by the cast that
    made the bf16 value float32."""
    with torch.enable_grad():
        leaves = [x.detach().to(torch.bfloat16).requires_grad_()
                  for x in (u, wgt, bias)]
        vs = sequential_routing_from_uhat(predict_capsules_bf16(*leaves),
                                          num_iter, mask_pad_capsule,
                                          bf16=True)
        return torch.autograd.grad(vs, leaves, dvs.to(vs.dtype))


def sequential_routing_bwd_factors(u_hat, vs, dvs, mask_pad_capsule):
    """The reverse-time recurrence of the SDR backward (one routing
    iteration), plain: the plain version of K2's step kernel.

    At step t (from T - 1 down to 0) recompute the agreement with v_{t-1}
    (zero at t = 0, read from the forward's output ``vs``), the softmax c,
    s and the squash factor; backpropagate dv = dvs[t] + the carry through
    the squash (ds), s and the softmax (da), and carry dv_{t-1} =
    sum_n da u_hat into step t - 1. The cotangent of u_hat is then c ds +
    da v_{t-1}, which this returns in factors: u_hat [B, T, in_n, out_n,
    out_d], vs and dvs [B, T, out_n, out_d] -> (c, da) [B, T, in_n, out_n]
    and ds [B, T, out_n, out_d].
    """
    out_n = u_hat.shape[3]
    pad_mask = (_pad_capsule_mask(out_n, u_hat.dtype, u_hat.device)
                if mask_pad_capsule else None)
    c_all = torch.empty(u_hat.shape[:4], dtype=u_hat.dtype,
                        device=u_hat.device)
    da_all = torch.empty_like(c_all)
    ds_all = torch.empty_like(vs)
    carry = torch.zeros_like(vs[:, 0])  # [B, out_n, out_d]
    for t in range(u_hat.shape[1] - 1, -1, -1):
        u_hat_t = u_hat[:, t]
        v_prev = vs[:, t - 1] if t > 0 else torch.zeros_like(carry)
        # recompute the step
        logits = torch.einsum("bnoi,boi->bno", u_hat_t, v_prev)
        if pad_mask is not None:
            logits = logits + pad_mask
        c = torch.softmax(logits, dim=2)
        s = torch.einsum("bno,bnoi->boi", c, u_hat_t)
        ds = _squash_vjp(s, dvs[:, t] + carry)
        # through s = sum_n c * u_hat and the softmax
        dc = torch.einsum("bnoi,boi->bno", u_hat_t, ds)
        da = c * (dc - torch.sum(dc * c, dim=2, keepdim=True))
        carry = torch.einsum("bno,bnoi->boi", da, u_hat_t)
        c_all[:, t], da_all[:, t], ds_all[:, t] = c, da, ds
    return c_all, da_all, ds_all


def _squash_vjp(s, dv):
    """The cotangent of s [..., out_d] through v = squash(s) = f(q) s, q =
    |s|^2: dv f(q) + 2 s <dv, s> f'(q)."""
    q = torch.sum(s * s, dim=-1, keepdim=True)
    inv_sqrt = 1.0 / torch.sqrt(q + 1e-7)
    factor = (q / (1.0 + q)) * inv_sqrt
    dfdq = inv_sqrt / ((1.0 + q) * (1.0 + q)) - 0.5 * (q / (1.0 + q)) * (
        inv_sqrt / (q + 1e-7))
    dq = torch.sum(dv * s, dim=-1, keepdim=True) * dfdq
    return dv * factor + 2.0 * s * dq


def sdr_weight_grads(u, wgt, vs, c, da, ds):
    """(du, dW, db) from du_hat's factors, plain: the plain version of K2's
    weight-gradient kernel. du_hat = c ds + da v_{t-1} (v_{-1} = 0) through
    the prediction u_hat = W u + b: dW = sum_bt du_hat (x) u, db = sum_bt
    du_hat, du = W^T du_hat. Shapes as :func:`sequential_routing_bwd_factors`
    returns them, u [B, T, in_n, in_d] and wgt [in_n, out_n, out_d, in_d]."""
    v_prev = torch.cat([torch.zeros_like(vs[:, :1]), vs[:, :-1]], dim=1)
    # [B, T, in_n, out_n, out_d]
    du_hat = c[..., None] * ds[:, :, None] + da[..., None] * v_prev[:, :, None]
    dbias = du_hat.sum(dim=(0, 1))
    dwgt = torch.einsum("btnoi,btnj->noij", du_hat, u)
    du = torch.einsum("btnoi,noij->btnj", du_hat, wgt)
    return du, dwgt, dbias


def _split_softmax(b, group):
    """softmax of ``b`` [..., O_local] over the out capsules of every rank
    of ``group`` (each holding its own O_local of them): (c, M, L), M the
    global row max (detached) and L the global row sum of exp(b - M), both
    [...]. JAX's partitioned softmax: two all-reduces."""
    m = distributed.all_reduce_max(b.amax(dim=-1), group)
    e = torch.exp(b - m[..., None])
    total = distributed.all_reduce_sum(e.sum(dim=-1), group)
    return e / total[..., None], m, total


def sequential_routing_tp(u, wgt, bias, num_iter, pad_owner, group,
                          return_stats=False, bf16=False, v_init=None,
                          step_valid=None):
    """SDR on a shard of the out capsules, plain PyTorch: the plain version
    of K1-tp (module docstring). ``u`` [B, T, in_n, in_d] is replicated
    over ``group`` (the ``model`` ranks); ``wgt`` [in_n, O_local, out_d,
    in_d] and ``bias`` [in_n, O_local, out_d] are this rank's shard;
    ``pad_owner``: the shard holds global capsule 0 on the last layer, so
    its PAD mask applies here. Returns this rank's outputs [B, T, O_local,
    out_d] and, with ``return_stats``, the global (M, L) of every step and
    iteration, [T, num_iter, B, in_n, 2] (the backward's input).
    Differentiable: u's gradient is summed over ``group``.

    ``bf16``: bf16 routing (K1-tp-bf16's plain version): u_hat =
    :func:`predict_capsules_bf16` of u, W and b rounded to bf16, each
    agreement taken against bf16(v) and each sum over rows with bf16(c),
    in float32, as :func:`_sdr_step` does; the logits, the split softmax's
    (M, L) and its exchange, the squash and the carried v stay float32.
    Returns float32.

    ``v_init`` [B, O_local, out_d] (this rank's part of the carry before
    step 0; zeros if None) and ``step_valid`` [T] or [B, T] bool (an
    invalid step emits zeros and leaves a zero carry; every step still
    takes part in the split softmax's exchange): streaming on a shard
    (K1-tp-stream's plain version), the semantics of
    :func:`sequential_routing`'s."""
    if bf16:
        dtype = torch.float32
        u = distributed.copy_to_group(u.float(), group)
        u_hat = predict_capsules_bf16(
            *(x.to(torch.bfloat16) for x in (u, wgt, bias))).float()
    else:
        dtype = _compute_dtype(u.dtype)
        u = distributed.copy_to_group(u.to(dtype), group)
        u_hat = predict_capsules(u, wgt.to(dtype), bias.to(dtype))
    batch, seq_len, _, out_n, out_d = u_hat.shape
    pad_mask = (_pad_capsule_mask(out_n, dtype, u.device) if pad_owner
                else None)
    if v_init is None:
        v = torch.zeros((batch, out_n, out_d), dtype=dtype, device=u.device)
    else:
        v = v_init.to(dtype)
    if step_valid is not None:
        step_valid = torch.as_tensor(step_valid, device=u.device).expand(
            batch, seq_len)[:, :, None, None]
    outs, stats = [], []
    for t in range(seq_len):
        u_hat_t = u_hat[:, t]
        b_acc = torch.zeros(u_hat_t.shape[:3], dtype=dtype, device=u.device)
        for _ in range(num_iter):
            b_acc = b_acc + torch.einsum("bnoi,boi->bno", u_hat_t,
                                         round_bf16(v) if bf16 else v)
            if pad_mask is not None:
                b_acc = b_acc + pad_mask
            c, m, total = _split_softmax(b_acc, group)
            v = squash(torch.einsum("bno,bnoi->boi",
                                    round_bf16(c) if bf16 else c, u_hat_t),
                       dim=-1)
            stats.append(torch.stack([m, total.detach()], dim=-1))
        if step_valid is not None:
            v = torch.where(step_valid[:, t], v, 0.0)
        outs.append(v)
    out = torch.stack(outs, dim=1)
    if not return_stats:
        return out
    return out, torch.stack(stats).reshape(seq_len, num_iter,
                                           *stats[0].shape)


def sequential_routing_tp_bwd_bf16(u, wgt, bias, dvs, pad_owner, group,
                                   num_iter=1):
    """The split bf16 SDR's backward, plain: autograd through
    ``sequential_routing_tp(..., bf16=True)``'s loop on bf16 leaves, the
    plain version of K2-tp-bf16 (one routing iteration there), the
    counterpart of :func:`sequential_routing_bwd_bf16` on a shard. u
    (replicated), this rank's wgt and bias, dvs the cotangent of this
    rank's float32 outputs -> (du, dW, db), bf16: du the whole gradient of
    u (the ranks' float32 parts summed over ``group``, then rounded), dW
    and db the shard's, each a float32 sum rounded once."""
    with torch.enable_grad():
        leaves = [x.detach().to(torch.bfloat16).requires_grad_()
                  for x in (u, wgt, bias)]
        vs = sequential_routing_tp(*leaves, num_iter, pad_owner, group,
                                   bf16=True)
        return torch.autograd.grad(vs, leaves, dvs.to(vs.dtype))


def sequential_routing_tp_bwd_factors(u_hat, vs, dvs, pad_owner, group,
                                      stats, bf16=False):
    """The reverse-time recurrence of the split SDR's backward (one
    routing iteration), plain: the plain version of K2-tp's two step
    kernels. As :func:`sequential_routing_bwd_factors` on this rank's
    u_hat [B, T, in_n, O_local, out_d], vs and dvs [B, T, O_local, out_d],
    with c taken from the forward's global (M, L) ``stats`` [T, 1, B,
    in_n, 2] (no exchange) and each row's sum_o c dc summed over
    ``group`` (one SUM all-reduce a step). Returns (c, da, ds). ``bf16``:
    the step kernels' bf16 instances (u_hat the bf16 prediction's values):
    the logits against bf16(v_{t-1}), s with bf16(c), dc and the carry
    rounded to bf16, as autograd through the bf16 forward rounds them."""
    rnd = round_bf16 if bf16 else (lambda x: x)
    out_n = u_hat.shape[3]
    pad_mask = (_pad_capsule_mask(out_n, u_hat.dtype, u_hat.device)
                if pad_owner else None)
    c_all = torch.empty(u_hat.shape[:4], dtype=u_hat.dtype,
                        device=u_hat.device)
    da_all = torch.empty_like(c_all)
    ds_all = torch.empty_like(vs)
    carry = torch.zeros_like(vs[:, 0])
    for t in range(u_hat.shape[1] - 1, -1, -1):
        u_hat_t = u_hat[:, t]
        v_prev = vs[:, t - 1] if t > 0 else torch.zeros_like(carry)
        logits = torch.einsum("bnoi,boi->bno", u_hat_t, rnd(v_prev))
        if pad_mask is not None:
            logits = logits + pad_mask
        m, total = stats[t, 0, ..., 0], stats[t, 0, ..., 1]
        c = torch.exp(logits - m[..., None]) / total[..., None]
        s = torch.einsum("bno,bnoi->boi", rnd(c), u_hat_t)
        ds = _squash_vjp(s, dvs[:, t] + carry)
        dc = rnd(torch.einsum("bnoi,boi->bno", u_hat_t, ds))
        row = distributed.all_reduce_sum(torch.sum(dc * c, dim=2), group)
        da = c * (dc - row[..., None])
        carry = rnd(torch.einsum("bno,bnoi->boi", da, u_hat_t))
        c_all[:, t], da_all[:, t], ds_all[:, t] = c, da, ds
    return c_all, da_all, ds_all


def sequential_routing_tp_bwd(u, wgt, bias, vs, dvs, pad_owner, group,
                              stats):
    """The split SDR's backward for one routing iteration, plain PyTorch:
    the plain version of K2-tp, the counterpart of
    :func:`sequential_routing_bwd` on a shard. u [B, T, in_n, in_d]
    (replicated), this rank's wgt [in_n, O_local, out_d, in_d] and bias,
    its outputs vs and their cotangent dvs [B, T, O_local, out_d], and the
    forward's global (M, L) ``stats`` (:func:`sequential_routing_tp`) ->
    (du, dW, db): du the whole gradient of u (the ranks' parts summed over
    ``group`` once, after the loop), dW and db this shard's."""
    if stats.shape[1] != 1:
        raise ValueError("the split SDR's backward takes one routing "
                         "iteration: stats must be [T, 1, B, in_n, 2], got "
                         "%s" % (tuple(stats.shape),))
    out_dtypes = (u.dtype, wgt.dtype, bias.dtype)
    dtype = _compute_dtype(u.dtype)
    u, wgt, bias = u.to(dtype), wgt.to(dtype), bias.to(dtype)
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    vs = vs.to(dtype).reshape(vs.shape[0], vs.shape[1], out_n, out_d)
    dvs = dvs.to(dtype).reshape(vs.shape)
    u_hat = predict_capsules(u, wgt, bias)
    c, da, ds = sequential_routing_tp_bwd_factors(
        u_hat, vs, dvs, pad_owner, group, stats.to(dtype))
    du, dwgt, dbias = sdr_weight_grads(u, wgt, vs, c, da, ds)
    du = distributed.all_reduce_sum(du, group)
    return tuple(x.to(d) for x, d in zip((du, dwgt, dbias), out_dtypes))


def sequential_routing_tp_colaunch(u, wgts, biases, num_iter, pad,
                                   bf16=False, v_inits=None,
                                   step_valid=None):
    """Every rank's shard of the out capsules routed in one process, plain
    PyTorch: the plain version of K1-tp's co-launch
    (``routing_cuda.sequential_routing_tp_colaunch_cuda``). ``wgts`` and
    ``biases`` the ranks' shards in rank order, ``pad``: rank 0's shard
    holds the PAD capsule. The softmax split over every shard is the
    softmax over the shards joined, so this is
    :func:`sequential_routing_tp` on the joined W with no group (``bf16``,
    ``step_valid`` and the shards' carries ``v_inits``, joined, as it
    takes them). Returns ([out_r], [the global (M, L)] a rank)."""
    out, stats = sequential_routing_tp(
        u, torch.cat(list(wgts), dim=1), torch.cat(list(biases), dim=1),
        num_iter, pad, None, return_stats=True, bf16=bf16,
        v_init=None if v_inits is None else torch.cat(list(v_inits), dim=1),
        step_valid=step_valid)
    return ([x.contiguous() for x in torch.split(out, wgts[0].shape[1],
                                                 dim=2)],
            [stats] * len(wgts))


def sequential_routing_tp_bwd_colaunch(u, wgts, biases, vss, dvss, statss,
                                       pad, bf16=False):
    """The backward of :func:`sequential_routing_tp_colaunch`, one routing
    iteration, plain PyTorch: the plain version of K2-tp's co-launch. Each
    shard's outputs ``vss``, their cotangents ``dvss`` and the forward's
    (M, L) ``statss`` in rank order -> (du, [dW_r], [db_r]); ``bf16``: of
    the bf16 forward (:func:`sequential_routing_tp_bwd_bf16`, which
    recomputes the forward and reads neither ``vss`` nor ``statss``), in
    bf16."""
    out_n = wgts[0].shape[1]
    wgt, bias = torch.cat(list(wgts), dim=1), torch.cat(list(biases), dim=1)
    if bf16:
        du, dwgt, dbias = sequential_routing_tp_bwd_bf16(
            u, wgt, bias, torch.cat(list(dvss), dim=2), pad, None)
    else:
        du, dwgt, dbias = sequential_routing_tp_bwd(
            u, wgt, bias, torch.cat(list(vss), dim=2),
            torch.cat(list(dvss), dim=2), pad, None, statss[0])
    return (du, list(torch.split(dwgt, out_n, dim=1)),
            list(torch.split(dbias, out_n, dim=1)))


def route_layer(u, wgt, bias, num_iter, is_context, is_last_layer,
                bf16=False, shard=None):
    """One capsule layer: prediction + routing (DR or SDR).

    SDR goes through ``SDRFunction``: the K1 and K2 kernels (their bf16
    variants with ``bf16``, bf16 routing) when ``u`` is a CUDA tensor, the
    plain :func:`sequential_routing` and its backward when it lies on the
    CPU; nothing else decides. SDR computes in float32 on bf16 inputs, or
    in bf16 routing, and returns u's dtype (JAX's ``sequential_routing``).
    DR is plain PyTorch everywhere, differentiated by autograd, in u's
    dtype (JAX's DR ignores bf16 routing too).

    ``shard`` (offset, whole out_n, group): ``wgt`` and ``bias`` are this
    rank's shard of the out capsules on the ``model`` axis
    (``parallel/sharding_rules.apply_rules``), and the layer routes with
    the softmax split over ``group``: SDR through ``SDRTPFunction`` (K1-tp
    and K2-tp on a CUDA tensor, their bf16 variants with ``bf16``;
    :func:`sequential_routing_tp` and its backward on the CPU), DR through
    :func:`dynamic_routing` with ``group`` (which ignores ``bf16``, as
    unsharded). The PAD mask applies on the rank whose shard starts at
    capsule 0. Returns this rank's out capsules [B, T, O_local, out_d].
    """
    if num_iter < 1:
        raise ValueError(
            "routing needs --model-caps-iter >= 1 (got %d): with 0 "
            "iterations DR has no output and SDR would silently emit the "
            "zero carry for every frame" % num_iter
        )
    group, mask_pad_capsule = None, is_last_layer
    if shard is not None:
        offset, _, group = shard
        mask_pad_capsule = bool(is_last_layer) and offset == 0
        if is_context:
            return SDRTPFunction.apply(u, wgt, bias, num_iter,
                                       mask_pad_capsule, group, bf16)
    if is_context:
        return SDRFunction.apply(u, wgt, bias, num_iter, is_last_layer, bf16)
    u_hat = predict_capsules(distributed.copy_to_group(u, group), wgt, bias)
    out = dynamic_routing(u_hat, num_iter, mask_pad_capsule, group)
    return out.to(u.dtype)


def _sdr_step_factored(u_t, wgt, bias, v_prev, num_iter, pad_mask,
                       group=None):
    """One SDR timestep without materialising u_hat
    (``srf_tpu/ops/routing.py:_sdr_step_factored``): routing reads u_hat =
    W u + b only through <u_hat, v> = (W^T v) u + b v and sum_n c u_hat =
    (c (x) u) W + c b, so neither forms it. u_t [B, in_n, in_d], wgt
    [in_n, out_n, out_d, in_d], bias [in_n, out_n, out_d], v_prev [B,
    out_n, out_d]; with a leading layer axis on all four (the wavefront's
    stacked middle layers, JAX's ``vmap``) it routes each layer with its
    own weights. The same function as :func:`_sdr_step` on u_hat. With
    ``group`` (the ``model`` ranks), wgt, bias and v_prev are this rank's
    shard of the out capsules and the softmax is split across ``group``
    (:func:`_split_softmax`, F24's (m, l) combine as two all-reduces);
    u_t enters through ``copy_to_group``."""
    p = "l" if wgt.dim() == 5 else ""
    u_t = distributed.copy_to_group(u_t, group)
    b_acc = torch.zeros(u_t.shape[:-1] + wgt.shape[-3:-2], dtype=u_t.dtype,
                        device=u_t.device)  # [(l,) B, in_n, out_n]
    v = v_prev
    for _ in range(num_iter):
        r = torch.einsum(f"{p}noij,{p}boi->{p}bnoj", wgt, v)
        b_acc = b_acc + (torch.einsum(f"{p}bnoj,{p}bnj->{p}bno", r, u_t)
                         + torch.einsum(f"{p}noi,{p}boi->{p}bno", bias, v))
        if pad_mask is not None:
            b_acc = b_acc + pad_mask
        c = (torch.softmax(b_acc, dim=-1) if group is None
             else _split_softmax(b_acc, group)[0])
        pc = torch.einsum(f"{p}bno,{p}bnj->{p}bonj", c, u_t)
        s = (torch.einsum(f"{p}bonj,{p}noij->{p}boi", pc, wgt)
             + torch.einsum(f"{p}bno,{p}noi->{p}boi", c, bias))
        v = squash(s, dim=-1)
    return v


def _ln_drop(flat, scale, ln_bias, ln_eps, dropout_rate=0.0, keep=None):
    """Flattened-capsule LayerNorm and inverted dropout
    (``srf_tpu/ops/routing.py:_ln_drop``): ``flat`` [..., out_n*out_d]
    normalised over its last axis with the two-pass variance of
    ``jnp.var`` (not flax's E[x^2] - E[x]^2), scaled and shifted; where a
    ``keep`` mask is given, the kept entries scaled by 1 / (1 -
    dropout_rate) and the others zeroed."""
    mean = flat.mean(dim=-1, keepdim=True)
    centred = flat - mean
    var = (centred * centred).mean(dim=-1, keepdim=True)
    flat = centred * torch.rsqrt(var + ln_eps) * scale + ln_bias
    if keep is not None:
        flat = torch.where(keep, flat / (1.0 - dropout_rate), 0.0)
    return flat


def _window_of(rows):
    """Ring-buffer rows [..., window, B, n, d] -> the window's capsules
    [..., B, window*n, d], frame-major (:func:`window_stack`'s order)."""
    moved = rows.movedim(-4, -3)
    return moved.reshape(moved.shape[:-3] + (-1, moved.shape[-1]))


def wavefront_sdr_stack(u, layer_params, lpad, rpad, num_iter, ln_params,
                        ln_eps=1e-3, dropout_rate=0.0, generator=None,
                        remat=True, shards=None):
    """The whole SDR capsule stack as one loop over time
    (``--tpu-routing-kernel=wavefront``; ``srf_tpu/ops/routing.py:
    wavefront_sdr_stack``, plain PyTorch on every device: JAX runs it as
    one ``lax.scan`` of XLA ops, no Pallas kernel).

    Layer i at step tau computes its time t = tau - i*delay, delay = rpad +
    1, so that it reads only what layer i-1 wrote at earlier steps: one
    loop of T + (L-1)*delay steps routes every layer, instead of L loops of
    T. Layer 0 reads the windowed input frame; layers 1..L-1 read their
    window out of one ring buffer [L-1, window, B, ch, cd] of the last
    ``window`` outputs of layers 0..L-2; the L-2 middle layers (one
    geometry) route stacked over a leading layer axis; the last layer takes
    the PAD-capsule mask. A layer outside its times writes zeros to its
    output and its carried v (the layered path's window zero padding).
    Each layer's output is its flattened LayerNorm (:func:`_ln_drop`) and
    dropout; the same function as the layered path.

    u [B, T, n0, d0] (the primary capsules after their LayerNorm and
    dropout); ``layer_params`` [(W [in_n, out_n, out_d, in_d], b [in_n,
    out_n, out_d])] per layer; ``ln_params`` [(scale, bias)] of each
    layer's LayerNorm over out_n*out_d. Computes in float32 (float64 for a
    float64 u) and returns [B, T, class_n, class_d] in u's dtype.

    ``dropout_rate`` > 0 drops each layer's output, the masks drawn from
    ``generator`` (the global RNG when None) before the loop: JAX draws a
    stream per (layer, step) with ``fold_in``, the port one draw per kind
    of layer, with the same distribution (F21). ``remat`` checkpoints each
    step (``torch.utils.checkpoint``, JAX's ``jax.checkpoint(body)``) when
    autograd records; the masks come in from outside, so the recompute
    sees the same ones. Each step routes with :func:`_sdr_step_factored`
    (JAX's default, ``factored=True``). With one layer the stack is that
    layer's SDR through :func:`route_layer` (K1 and K2 on a CUDA tensor).
    The loop index is a host int: the validity tests read no device value,
    and no step writes into a tensor in place.

    ``shards`` (one entry a layer, None where replicated): the last layer's
    (offset, whole out_n, group) where its W and b are this rank's shard of
    the out capsules on the ``model`` axis (``apply_rules`` shards no other
    layer): each loop step routes the shard with its softmax split over
    ``group`` (``_sdr_step_factored(..., group)``), the PAD mask on the
    rank whose shard starts at capsule 0, and gathers the ranks' capsules
    before the LayerNorm, as the layered path does (one layer: through
    :func:`route_layer` with the shard).
    """
    batch, seq_len = u.shape[0], u.shape[1]
    window = lpad + rpad + 1
    n_layers = len(layer_params)
    delay = rpad + 1
    shards = list(shards or [None] * n_layers)
    if any(shards[:-1]):
        raise ValueError("the wavefront splits the last layer only (the one "
                         "apply_rules shards), got shards %s" % shards)
    last_shard = shards[-1]
    group = None if last_shard is None else last_shard[2]
    total_steps = seq_len + (n_layers - 1) * delay
    dtype = _compute_dtype(u.dtype)
    device = u.device

    prev_n, prev_d = u.shape[2], u.shape[3]
    for i, (wgt, _) in enumerate(layer_params):
        in_n, out_n, out_d, in_d = wgt.shape
        if i == n_layers - 1 and last_shard is not None:
            out_n = last_shard[1]
        assert in_n == window * prev_n and in_d == prev_d, (
            wgt.shape, (window, prev_n, prev_d))
        prev_n, prev_d = out_n, out_d
    layer_params = [(w.to(dtype), b.to(dtype)) for w, b in layer_params]
    ln_params = [(s.to(dtype), b.to(dtype)) for s, b in ln_params]

    def keep_masks(*shape):
        if dropout_rate <= 0.0:
            return None
        return torch.rand(shape, generator=generator,
                          device=device) >= dropout_rate

    u_win = window_stack(u.to(dtype), lpad, rpad)
    if n_layers == 1:  # the layered path's SDR over the whole utterance
        wgt, bias = layer_params[0]
        out = route_layer(u_win, wgt, bias, num_iter, True,
                          is_last_layer=True, shard=last_shard)
        if last_shard is not None:
            out = distributed.gather_along(out, group, dim=2)
        keep = keep_masks(batch, seq_len, out.shape[2] * out.shape[3])
        flat = _ln_drop(out.reshape(batch, seq_len, -1), *ln_params[0],
                        ln_eps, dropout_rate, keep)
        return flat.reshape(out.shape).to(u.dtype)

    def route(u_t, wgt, bias, v_prev, pad_mask, group=None):
        return _sdr_step_factored(u_t, wgt, bias, v_prev, num_iter, pad_mask,
                                  group)

    ch, cd = layer_params[0][0].shape[1:3]
    # the last layer's capsules on this rank (its shard), and in all
    local_n, class_d = layer_params[-1][0].shape[1:3]
    class_n = local_n if last_shard is None else last_shard[1]
    n_mid = n_layers - 2
    (w0, b0), (w_last, b_last) = layer_params[0], layer_params[-1]
    keep_first = keep_masks(seq_len, batch, ch * cd)
    keep_last = keep_masks(seq_len, batch, class_n * class_d)
    if n_mid:
        w_mid = torch.stack([w for w, _ in layer_params[1:-1]])
        b_mid = torch.stack([b for _, b in layer_params[1:-1]])
        # [n_mid, 1, ch*cd]
        ln_mid = [torch.stack(x)[:, None] for x in zip(*ln_params[1:-1])]
        # middle layer m+1 computes t = tau - (m+1)*delay: [total, n_mid]
        t_mid = (torch.arange(total_steps)[:, None]
                 - delay * torch.arange(1, n_mid + 1))
        valid_mid = ((t_mid >= 0) & (t_mid < seq_len)).to(device)[
            ..., None, None, None]
        keep_mid = keep_masks(total_steps, n_mid, batch, ch * cd)
    pad_mask = (_pad_capsule_mask(local_n, dtype, device)
                if last_shard is None or last_shard[0] == 0 else None)
    zeros = torch.zeros((batch, ch, cd), dtype=dtype, device=device)

    def step(tau, buf, v_first, v_mid, v_last):
        # layer 0 at time tau, on the windowed input frame
        if tau < seq_len:
            v_first = route(u_win[:, tau], w0, b0, v_first, None)
            out0 = _ln_drop(
                v_first.reshape(batch, -1), *ln_params[0], ln_eps,
                dropout_rate, None if keep_first is None
                else keep_first[tau]).reshape(batch, ch, cd)
        else:
            v_first = out0 = zeros
        push = out0[None]
        # the middle layers, stacked
        if n_mid:
            vm = route(_window_of(buf[:n_mid]), w_mid, b_mid, v_mid, None)
            flat = _ln_drop(vm.reshape(n_mid, batch, -1), *ln_mid, ln_eps,
                            dropout_rate, None if keep_mid is None
                            else keep_mid[tau])
            valid = valid_mid[tau]
            v_mid = torch.where(valid, vm, 0.0)
            push = torch.cat([push, torch.where(
                valid, flat.reshape(vm.shape), 0.0)])
        # the last layer at t = tau - (L-1)*delay, PAD-capsule mask
        t_last = tau - (n_layers - 1) * delay
        out_l = None
        if 0 <= t_last < seq_len:
            v_last = route(_window_of(buf[-1]), w_last, b_last, v_last,
                           pad_mask, group)
            v_all = (v_last if group is None
                     else distributed.gather_along(v_last, group, dim=1))
            out_l = _ln_drop(
                v_all.reshape(batch, -1), *ln_params[-1], ln_eps,
                dropout_rate, None if keep_last is None
                else keep_last[t_last]).reshape(batch, class_n, class_d)
        # the ring buffer moves on by one step, out of place
        buf = torch.cat([buf[:, 1:], push[:, None]], dim=1)
        return buf, v_first, v_mid, v_last, out_l

    if remat and torch.is_grad_enabled():
        run = functools.partial(torch.utils.checkpoint.checkpoint, step,
                                use_reentrant=False, preserve_rng_state=False)
    else:
        run = step
    carry = (torch.zeros((n_layers - 1, window, batch, ch, cd), dtype=dtype,
                         device=device),
             zeros,
             (torch.zeros((n_mid, batch, ch, cd), dtype=dtype, device=device)
              if n_mid else None),
             torch.zeros((batch, local_n, class_d), dtype=dtype,
                         device=device))
    outs = []
    for tau in range(total_steps):
        *carry, out_l = run(tau, *carry)
        if out_l is not None:
            outs.append(out_l)
    return torch.stack(outs, dim=1).to(u.dtype)


def split_begin(n, parts, q):
    """Part q's first item when n items are split into ``parts`` contiguous
    parts as evenly as they go, the first n % parts taking one more (the
    cluster scan's split of rows and out capsules, ``csrc/sdr_plan.cuh``)."""
    base, extra = divmod(n, parts)
    return q * base + min(q, extra)


def _row_slices(in_n, row_splits):
    return [slice(split_begin(in_n, row_splits, q),
                  split_begin(in_n, row_splits, q + 1))
            for q in range(row_splits)]


def _sliced_sum(coef, u_hat_t, slices):
    """sum_n coef[b,n,o] u_hat_t[b,n,o,:], each slice of rows summed apart and
    the slices' sums added in order (the cluster's reduce-scatter)."""
    total = None
    for rows in slices:
        part = torch.einsum("bno,bnoi->boi", coef[:, rows], u_hat_t[:, rows])
        total = part if total is None else total + part
    return total


def sequential_routing_scan_partitioned(u, wgt, bias, num_iter,
                                        mask_pad_capsule, batch_tile,
                                        row_splits):
    """:func:`sequential_routing` in K3's order of sums
    (``csrc/sdr_scan_fwd.cu``): the batch in tiles of ``batch_tile``
    utterances (a cluster each), the in-capsule rows in ``row_splits``
    contiguous slices (a CTA each, split as ``split_begin``), s summed over
    each slice and the slices' sums added in rank order, the logits of
    iteration k taken against v_{t-1} + v_1 + ... + v_k. Plain PyTorch, for
    the tests; nothing on the card's path calls it."""
    out_dtype = u.dtype
    dtype = _compute_dtype(u.dtype)
    u_hat = predict_capsules(u.to(dtype), wgt.to(dtype), bias.to(dtype))
    batch, seq_len, in_n, out_n, out_d = u_hat.shape
    pad = (_pad_capsule_mask(out_n, dtype, u.device)
           if mask_pad_capsule else torch.zeros(out_n, dtype=dtype,
                                                device=u.device))
    slices = _row_slices(in_n, row_splits)
    tiles = []
    for b0 in range(0, batch, batch_tile):
        uh = u_hat[b0:b0 + batch_tile]
        vsum = torch.zeros((uh.shape[0], out_n, out_d), dtype=dtype,
                           device=u.device)
        steps = []
        for t in range(seq_len):
            for it in range(num_iter):
                logits = (torch.einsum("bnoi,boi->bno", uh[:, t], vsum)
                          + (it + 1) * pad)
                s = _sliced_sum(torch.softmax(logits, dim=2), uh[:, t],
                                slices)
                v = squash(s, dim=-1)
                vsum = v if it + 1 == num_iter else vsum + v
            steps.append(v)
        tiles.append(torch.stack(steps, dim=1))
    return torch.cat(tiles).to(out_dtype)


def sequential_routing_scan_bwd_partitioned(u, wgt, bias, vs, dvs,
                                            mask_pad_capsule, batch_tile,
                                            row_splits):
    """:func:`sequential_routing_bwd` in K4's order of sums
    (``csrc/sdr_scan_bwd.cu``), one routing iteration: per batch tile (a
    cluster) time runs backwards; s and the carry are summed over each
    slice of rows and the slices' sums added in rank order; dW and db are
    summed over the tile's utterances and steps into one partial per
    cluster, and the partials are added in cluster order. Returns (du, dW,
    db). Plain PyTorch, for the tests; nothing on the card's path calls
    it."""
    out_dtypes = (u.dtype, wgt.dtype, bias.dtype)
    dtype = _compute_dtype(u.dtype)
    u, wgt, bias = u.to(dtype), wgt.to(dtype), bias.to(dtype)
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    vs = vs.to(dtype).reshape(vs.shape[0], vs.shape[1], out_n, out_d)
    dvs = dvs.to(dtype).reshape(vs.shape)
    u_hat = predict_capsules(u, wgt, bias)
    batch, seq_len, in_n = u.shape[:3]
    pad_mask = (_pad_capsule_mask(out_n, dtype, u.device)
                if mask_pad_capsule else None)
    slices = _row_slices(in_n, row_splits)
    du = torch.empty_like(u)
    dwgt = dbias = None
    for b0 in range(0, batch, batch_tile):
        tile = slice(b0, b0 + batch_tile)
        carry = torch.zeros_like(vs[tile, 0])
        dw_part = torch.zeros_like(wgt)
        db_part = torch.zeros_like(bias)
        for t in range(seq_len - 1, -1, -1):
            uh = u_hat[tile, t]
            v_prev = (vs[tile, t - 1] if t > 0 else torch.zeros_like(carry))
            logits = torch.einsum("bnoi,boi->bno", uh, v_prev)
            if pad_mask is not None:
                logits = logits + pad_mask
            c = torch.softmax(logits, dim=2)
            s = _sliced_sum(c, uh, slices)
            q = torch.sum(s * s, dim=2, keepdim=True)
            inv_sqrt = 1.0 / torch.sqrt(q + 1e-7)
            ratio = q / (1.0 + q)
            dv = dvs[tile, t] + carry
            dfdq = (inv_sqrt / ((1.0 + q) * (1.0 + q))
                    - 0.5 * ratio * (inv_sqrt / (q + 1e-7)))
            dq = torch.sum(dv * s, dim=2, keepdim=True) * dfdq
            ds = dv * (ratio * inv_sqrt) + 2.0 * s * dq
            dc = torch.einsum("bnoi,boi->bno", uh, ds)
            da = c * (dc - torch.sum(dc * c, dim=2, keepdim=True))
            carry = _sliced_sum(da, uh, slices)
            du_hat = (c[..., None] * ds[:, None]
                      + da[..., None] * v_prev[:, None])
            db_part = db_part + du_hat.sum(dim=0)
            dw_part = dw_part + torch.einsum("bnoi,bnj->noij", du_hat,
                                             u[tile, t])
            du[tile, t] = torch.einsum("bnoi,noij->bnj", du_hat, wgt)
        dwgt = dw_part if dwgt is None else dwgt + dw_part
        dbias = db_part if dbias is None else dbias + db_part
    return tuple(x.to(d) for x, d in zip((du, dwgt, dbias), out_dtypes))
