"""bf16 routing (``--tpu-routing-bf16``) in the port: the plain bf16 SDR
(``ops/routing.sequential_routing(..., bf16=True)``, the plain version of
K1's bf16 variant) and its backward by autograd (``SDRFunction`` in bf16
mode on the CPU, the plain version of K2's bf16 variant) against JAX's
``sequential_routing(compute_dtype=bfloat16)``, at the SRF-TIMIT layer
geometries over 2-3 steps and the SRF-WSJ layer 0:

- the forward against JAX's materialized scan (``impl="xla"``), whose
  rounding points the port follows: within 1e-3 of the output's largest
  entry (measured up to 1.6e-7 at one routing iteration: float32 sums in
  other orders; up to 2.9e-4 at two, where such a sum rounds a c or a v to
  the other bf16 neighbour, a bf16 ulp of one term of a row's sum); against
  JAX's default factored scan (``auto``), which rounds W^T v and c (x) u
  instead of u_hat, within 1e-2 of it (F19; measured up to 3.6e-3);
- the backward: du, dW and db against JAX's, within 2.5e-2 of each
  largest entry (F20: JAX's transposed scan sums dW and db in bf16 step by
  step, the port in float32 with one rounding at the end; measured up to
  1.1e-2); and the port's float32 sums against the same rounding points
  with float64 sums: within 1.6e-2 of the largest entry (4 bf16 ulps;
  measured up to 1.8e-3), and nearer to them than JAX's bf16 sums are;
- the model and registry flags: ``routing_bf16`` reaches ``route_layer``,
  and ``pallas`` and ``xla_flat`` keep JAX's ValueError (in
  ``test_torch_registry.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops import routing as jax_routing
from srf_tpu_torch.ops import routing
from srf_tpu_torch.ops.routing_cuda import SDRFunction
from srf_tpu_torch.ops.squash import squash

torch.set_num_threads(1)

# (in_n, out_n, out_d, in_d), PAD mask, B, T
GEOMETRIES = [
    ((180, 30, 8, 8), False, 2, 3),   # SRF-TIMIT layer 0
    ((90, 30, 8, 8), False, 2, 3),    # its middle layers
    ((90, 63, 8, 8), True, 2, 2),     # its last layer
    ((300, 30, 20, 20), False, 1, 2),  # SRF-WSJ layer 0
]


def _problem(geometry, batch, seq_len, seed):
    in_n, out_n, out_d, in_d = geometry
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, seq_len, in_n, in_d).astype(np.float32),
            (rng.randn(in_n, out_n, out_d, in_d) * 0.1).astype(np.float32),
            (rng.randn(in_n, out_n, out_d) * 0.1).astype(np.float32))


def _jax_sdr(factored, mask, num_iter=1):
    def fn(u, w, b):
        return jax_routing.sequential_routing(
            u, w, b, num_iter, mask, compute_dtype=jnp.bfloat16,
            factored=factored)
    return fn


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("geometry,mask,batch,seq_len", GEOMETRIES)
@pytest.mark.parametrize("num_iter", [1, 2])
def test_forward_matches_jax(geometry, mask, batch, seq_len, num_iter):
    u, w, b = _problem(geometry, batch, seq_len, seed=num_iter)
    got = routing.sequential_routing(*map(torch.from_numpy, (u, w, b)),
                                     num_iter, mask, bf16=True)
    assert got.dtype == torch.float32
    materialized = np.asarray(_jax_sdr(False, mask, num_iter)(u, w, b))
    factored = np.asarray(_jax_sdr(True, mask, num_iter)(u, w, b))
    assert _rel(got, materialized) <= 1e-3
    assert _rel(got, factored) <= 1e-2
    # bf16 u in, bf16 out (JAX returns u's dtype)
    out = routing.sequential_routing(
        *(torch.from_numpy(x).bfloat16() for x in (u, w, b)), num_iter, mask,
        bf16=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.bfloat16())


def _float64_reference(u, w, b, dvs, mask):
    """(du, dW, db) at the port's rounding points with float64 sums: the
    bf16 values rounded where ``sequential_routing(..., bf16=True)``
    rounds them, every product and sum taken in float64."""
    def rnd(x):
        return x.to(torch.bfloat16).to(torch.float64)

    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (u, w, b)]
    ud, wd, bd = (x.to(torch.float64) for x in leaves)
    u_hat = rnd(rnd(torch.einsum("noij,btnj->btnoi", wd, ud)) + bd)
    out_n = w.shape[1]
    pad = torch.zeros(out_n, dtype=torch.float64)
    if mask:
        pad[0] = routing.NEG_INF
    v = torch.zeros(u.shape[0], out_n, w.shape[2], dtype=torch.float64)
    outs = []
    for t in range(u.shape[1]):
        logits = torch.einsum("bnoi,boi->bno", u_hat[:, t], rnd(v)) + pad
        c = torch.softmax(logits, dim=2)
        v = squash(torch.einsum("bno,bnoi->boi", rnd(c), u_hat[:, t]),
                   dim=-1)
        outs.append(v)
    grads = torch.autograd.grad(torch.stack(outs, 1), leaves,
                                torch.from_numpy(dvs).to(torch.float64))
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("geometry,mask,batch,seq_len", GEOMETRIES)
def test_backward_matches_jax_and_float64_sums(geometry, mask, batch,
                                               seq_len):
    u, w, b = _problem(geometry, batch, seq_len, seed=3)
    dvs = np.random.RandomState(4).randn(
        batch, seq_len, geometry[1], geometry[2]).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (u, w, b)]
    out = SDRFunction.apply(*leaves, 1, mask, True)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dvs))
    assert all(g.dtype == torch.float32 for g in got)
    # the gradients are the bf16 cotangents of the bf16 casts
    assert all(torch.equal(g, g.bfloat16().float()) for g in got)
    _, vjp = jax.vjp(_jax_sdr(False, mask), u, w, b)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dvs))]
    f64 = _float64_reference(u, w, b, dvs, mask)
    for name, g, j, r in zip(("du", "dW", "db"), got, want, f64):
        assert _rel(g, j) <= 2.5e-2, name
        assert _rel(g, r) <= 1.6e-2, name
    assert (max(_rel(g, r) for g, r in zip(got, f64))
            <= max(_rel(j, r) for j, r in zip(want, f64)))


def test_route_layer_takes_bf16_routing():
    u, w, b = _problem((90, 30, 8, 8), 2, 3, seed=5)
    args = [torch.from_numpy(x) for x in (u, w, b)]
    got = routing.route_layer(*args, 1, True, False, bf16=True)
    assert torch.equal(got, routing.sequential_routing(*args, 1, False,
                                                       bf16=True))
    assert not torch.equal(got, routing.route_layer(*args, 1, True, False))
