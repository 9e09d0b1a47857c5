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

Shapes (the JAX layouts):
    u      [B, T, in_n, in_d]      input capsules (after windowing)
    W      [in_n, out_n, out_d, in_d]
    bias   [in_n, out_n, out_d]
    v      [B, T, out_n, out_d]    output capsules
"""

import torch
import torch.nn.functional as F

from srf_tpu_torch.ops.routing_cuda import SDRFunction
from srf_tpu_torch.ops.squash import squash

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


def dynamic_routing(u_hat, num_iter, mask_pad_capsule):
    """DR: route all timesteps in parallel.

    Per iteration (reference: sequence_router_naive.py:200-206):
        b += pad_mask ; c = softmax(b, out) ; s = sum_in(c * u_hat)
        v = squash(s) ; b += <u_hat, v>
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
        c = torch.softmax(b, dim=3)
        s = torch.einsum("btno,btnoi->btoi", c, u_hat)
        v = squash(s, dim=-1)
        b = b + torch.einsum("btnoi,btoi->btno", u_hat, v)
    return v


def _compute_dtype(dtype):
    """float32 for float32 and narrower inputs, float64 for float64 (so
    ``gradcheck`` can hold the routing in double precision)."""
    return torch.promote_types(dtype, torch.float32)


def _sdr_step(u_hat_t, v_prev, num_iter, pad_mask):
    """One SDR timestep given u_hat_t [B, in_n, out_n, out_d].

    Routing logits accumulate agreement with v across the iterations; the
    first agreement term uses the *previous timestep's* output capsules
    (reference: sequence_router_naive.py:222-227).
    """
    b = torch.zeros(u_hat_t.shape[:3], dtype=u_hat_t.dtype,
                    device=u_hat_t.device)  # [B, in_n, out_n]
    v = v_prev
    for _ in range(num_iter):
        b = b + torch.einsum("bnoi,boi->bno", u_hat_t, v)
        if pad_mask is not None:
            b = b + pad_mask
        c = torch.softmax(b, dim=2)
        s = torch.einsum("bno,bnoi->boi", c, u_hat_t)
        v = squash(s, dim=-1)
    return v


def row_pitch(out_no):
    """Floats per in-capsule row of u_hat in the kernels' layout: out_n *
    out_d rounded up to a multiple of 4 (a bulk copy moves 16-byte
    multiples)."""
    return -(-out_no // 4) * 4


def predict_capsules_rows(u, wgt, bias):
    """The plain version of the prediction kernel (``csrc/sdr_stream.cuh``):
    :func:`predict_capsules` in the layout K1 and K2 stream, [B, T, in_n,
    P] with each in-capsule row's out_n * out_d entries zero-padded to
    P = ``row_pitch(out_n * out_d)``."""
    batch, seq_len, in_n = u.shape[:3]
    out_no = wgt.shape[1] * wgt.shape[2]
    u_hat = predict_capsules(u, wgt, bias).reshape(batch, seq_len, in_n,
                                                   out_no)
    return F.pad(u_hat, (0, row_pitch(out_no) - out_no))


def sequential_routing(u, wgt, bias, num_iter, mask_pad_capsule,
                       v_init=None, step_valid=None):
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
    """
    out_dtype = u.dtype
    dtype = _compute_dtype(u.dtype)
    u_hat = predict_capsules(u.to(dtype), wgt.to(dtype), bias.to(dtype))
    return sequential_routing_from_uhat(u_hat, num_iter, mask_pad_capsule,
                                        v_init, step_valid).to(out_dtype)


def sequential_routing_from_uhat(u_hat, num_iter, mask_pad_capsule,
                                 v_init=None, step_valid=None):
    """The SDR recurrence from given prediction vectors u_hat [B, T, in_n,
    out_n, out_d]: the plain version of K1's recurrence kernel. ``v_init``
    and ``step_valid`` as in :func:`sequential_routing`. Returns [B, T,
    out_n, out_d] in u_hat's dtype. ``sequential_routing_from_uhat.
    cuda_calls`` counts its calls on CUDA tensors: the card's model paths
    never take this loop (a kernel does), only the kernels' checks."""
    if u_hat.is_cuda:
        sequential_routing_from_uhat.cuda_calls += 1
    batch, seq_len, _, out_n, out_d = u_hat.shape
    pad_mask = (_pad_capsule_mask(out_n, u_hat.dtype, u_hat.device)
                if mask_pad_capsule else None)
    if v_init is None:
        v = torch.zeros((batch, out_n, out_d), dtype=u_hat.dtype,
                        device=u_hat.device)
    else:
        v = v_init.to(u_hat.dtype)
    if step_valid is not None:
        step_valid = torch.as_tensor(step_valid, device=u_hat.device)
        step_valid = step_valid.expand(batch, seq_len)[:, :, None, None]
    outs = []
    for t in range(seq_len):
        v = _sdr_step(u_hat[:, t], v, num_iter, pad_mask)
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
        q = torch.sum(s * s, dim=2, keepdim=True)
        inv_sqrt = 1.0 / torch.sqrt(q + 1e-7)
        factor = (q / (1.0 + q)) * inv_sqrt
        # backward through squash: v = factor(q) * s, q = |s|^2
        dv = dvs[:, t] + carry
        dfdq = inv_sqrt / ((1.0 + q) * (1.0 + q)) - 0.5 * (q / (1.0 + q)) * (
            inv_sqrt / (q + 1e-7))
        dq = torch.sum(dv * s, dim=2, keepdim=True) * dfdq
        ds = dv * factor + 2.0 * s * dq
        # through s = sum_n c * u_hat and the softmax
        dc = torch.einsum("bnoi,boi->bno", u_hat_t, ds)
        da = c * (dc - torch.sum(dc * c, dim=2, keepdim=True))
        carry = torch.einsum("bno,bnoi->boi", da, u_hat_t)
        c_all[:, t], da_all[:, t], ds_all[:, t] = c, da, ds
    return c_all, da_all, ds_all


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


def route_layer(u, wgt, bias, num_iter, is_context, is_last_layer):
    """One capsule layer: prediction + routing (DR or SDR).

    SDR goes through ``SDRFunction``: the K1 and K2 kernels when ``u`` is
    a CUDA tensor, the plain :func:`sequential_routing` and
    :func:`sequential_routing_bwd` when it lies on the CPU; nothing else
    decides. DR is plain PyTorch everywhere, differentiated by autograd.
    """
    if num_iter < 1:
        raise ValueError(
            "routing needs --model-caps-iter >= 1 (got %d): with 0 "
            "iterations DR has no output and SDR would silently emit the "
            "zero carry for every frame" % num_iter
        )
    if is_context:
        return SDRFunction.apply(u, wgt, bias, num_iter, is_last_layer)
    u_hat = predict_capsules(u, wgt, bias)
    out = dynamic_routing(u_hat, num_iter, mask_pad_capsule=is_last_layer)
    return out.to(u.dtype)


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
