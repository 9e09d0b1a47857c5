"""Dynamic routing cores (port of ``srf_tpu/ops/routing.py``).

- **DR** (``--model-caps-context=False``): all timesteps routed in parallel
  (reference math: sequence_router_naive.py:200-206). Plain PyTorch on
  every device; the JAX package had no TPU kernel for it either.
- **SDR** (``--model-caps-context=True``): a recurrence over time whose
  carry is the previous timestep's output capsules
  (reference math: sequence_router_naive.py:213-245).
  :func:`sequential_routing` is its plain PyTorch version, a Python loop
  over T; on a CUDA tensor :func:`route_layer` runs the hand-written kernel
  ``ops/routing_cuda.sequential_routing_cuda`` instead (K1, which replaces
  the TPU kernel ``srf_tpu/ops/routing_pallas.py:_sdr_fwd_kernel``).
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

from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
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


def _sdr_step(u_hat_t, v_prev, num_iter, pad_mask):
    """One SDR timestep given u_hat_t [B, in_n, out_n, out_d].

    Routing logits accumulate agreement with v across the iterations; the
    first agreement term uses the *previous timestep's* output capsules
    (reference: sequence_router_naive.py:222-227).
    """
    b = torch.zeros(u_hat_t.shape[:3], dtype=torch.float32,
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


def sequential_routing(u, wgt, bias, num_iter, mask_pad_capsule,
                       v_init=None, step_valid=None):
    """SDR, plain PyTorch: a loop over time carrying the previous outputs.

    The plain version of the K1 kernel (``routing_cuda``): the tests hold
    it to the JAX scan on the CPU, and the card holds the kernel to it.
    ``u`` is [B, T, in_n, in_d]; the weight multiply runs inside the time
    loop (the lowmemory plan). Returns [B, T, out_n, out_d].

    ``v_init``: initial carry [B, out_n, out_d] (streaming: the previous
    chunk's last output capsules); defaults to zeros (reference: v0 = 0,
    sequence_router_lowmemory.py:169).

    ``step_valid``: optional [T] bool; invalid steps contribute zero output
    AND a zero carry (streaming warm-up frames before t=0, which the batch
    implementation realizes as window zero padding).
    """
    batch, seq_len = u.shape[0], u.shape[1]
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    pad_mask = (_pad_capsule_mask(out_n, torch.float32, u.device)
                if mask_pad_capsule else None)
    if v_init is None:
        v = torch.zeros((batch, out_n, out_d), dtype=torch.float32,
                        device=u.device)
    else:
        v = v_init.to(torch.float32)
    outs = []
    for t in range(seq_len):
        u_hat_t = torch.einsum("noij,bnj->bnoi", wgt, u[:, t]) + bias[None]
        v = _sdr_step(u_hat_t, v, num_iter, pad_mask)
        if step_valid is not None:
            v = torch.where(step_valid[t], v, 0.0)
        outs.append(v)
    return torch.stack(outs, dim=1).to(u.dtype)


def route_layer(u, wgt, bias, num_iter, is_context, is_last_layer):
    """One capsule layer: prediction + routing (DR or SDR).

    SDR goes to the K1 kernel when ``u`` is a CUDA tensor and to the plain
    :func:`sequential_routing` when it lies on the CPU; nothing else
    decides. DR is plain PyTorch everywhere.
    """
    if num_iter < 1:
        raise ValueError(
            "routing needs --model-caps-iter >= 1 (got %d): with 0 "
            "iterations DR has no output and SDR would silently emit the "
            "zero carry for every frame" % num_iter
        )
    if is_context:
        if u.is_cuda:
            return sequential_routing_cuda(u, wgt, bias, num_iter,
                                           is_last_layer)
        return sequential_routing(u, wgt, bias, num_iter,
                                  mask_pad_capsule=is_last_layer)
    u_hat = predict_capsules(u, wgt, bias)
    out = dynamic_routing(u_hat, num_iter, mask_pad_capsule=is_last_layer)
    return out.to(u.dtype)
