"""The port's SDR backward against srf_tpu: the plain version of K2
(``sequential_routing_bwd``) against ``jax.vjp`` of the JAX scan and against
the Pallas K2 (``_pallas_sdr_bwd``) in interpret mode, float64 gradcheck of
``SDRFunction``, and ``SDRFunction`` against autograd through the plain loop
for one and two routing iterations. Tolerance rtol 1e-4 / atol 1e-5 on
gradients of magnitude ~1: the same float32 math with sums (dW and db over
B x T) taken in another order; measured ~5e-7. Also: the K2 wrapper refuses
CPU tensors, and a CPU tensor's forward and backward never reach a kernel.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops import routing as jax_routing
from srf_tpu.ops.routing_pallas import _pallas_sdr_bwd
from srf_tpu_torch.ops import routing, routing_cuda
from srf_tpu_torch.ops.routing_cuda import (SDRFunction,
                                            sequential_routing_bwd_cuda)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _problem(seed=0, B=3, T=7, in_n=6, in_d=4, out_n=5, out_d=3):
    """u, W, b and a cotangent dvs; B=3 is not a multiple of 8 (the Pallas
    kernel pads the batch to 8)."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, T, in_n, in_d).astype(np.float32)
    W = (rng.randn(in_n, out_n, out_d, in_d) * 0.3).astype(np.float32)
    b = (rng.randn(in_n, out_n, out_d) * 0.1).astype(np.float32)
    dvs = rng.randn(B, T, out_n, out_d).astype(np.float32)
    return u, W, b, dvs


def _plain_bwd(u, W, b, dvs, mask):
    u, W, b, dvs = (torch.from_numpy(x) for x in (u, W, b, dvs))
    vs = routing.sequential_routing(u, W, b, 1, mask)
    return routing.sequential_routing_bwd(u, W, b, vs, dvs, mask)


def _assert_grads(got, want):
    for name, g, w in zip(("du", "dW", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mask", [True, False])
def test_bwd_matches_jax_scan_vjp(mask):
    u, W, b, dvs = _problem()
    _, vjp = jax.vjp(
        lambda u_, w_, b_: jax_routing.sequential_routing(u_, w_, b_, 1, mask),
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b))
    _assert_grads(_plain_bwd(u, W, b, dvs, mask), vjp(jnp.asarray(dvs)))


@pytest.mark.parametrize("mask", [True, False])
def test_bwd_matches_pallas_k2_interpret(mask):
    u, W, b, dvs = _problem(seed=1, B=3, T=6)
    vs = jax_routing.sequential_routing(jnp.asarray(u), jnp.asarray(W),
                                        jnp.asarray(b), 1, mask)
    want = _pallas_sdr_bwd(jnp.asarray(u), jnp.asarray(W), jnp.asarray(b),
                           vs, jnp.asarray(dvs), mask, interpret=True)
    _assert_grads(_plain_bwd(u, W, b, dvs, mask), want)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (1, False), (2, True)])
def test_sdr_function_gradcheck_float64(num_iter, mask):
    u, W, b, _ = _problem(seed=2, B=2, T=4, in_n=4, in_d=3, out_n=3, out_d=2)
    inputs = tuple(torch.from_numpy(x).double().requires_grad_()
                   for x in (u, W, b))
    assert torch.autograd.gradcheck(
        lambda *x: SDRFunction.apply(*x, num_iter, mask), inputs)


@pytest.mark.parametrize("num_iter", [1, 2])
def test_sdr_function_matches_autograd_through_the_plain_loop(num_iter):
    u, W, b, dvs = _problem(seed=3, B=5, T=6)
    grads = []
    for fn in (lambda *x: SDRFunction.apply(*x, num_iter, True),
               lambda *x: routing.sequential_routing(*x, num_iter, True)):
        inputs = [torch.from_numpy(x).requires_grad_() for x in (u, W, b)]
        out = fn(*inputs)
        out.backward(torch.from_numpy(dvs))
        grads.append([x.grad for x in inputs])
    for name, g, w in zip(("du", "dW", "db"), *grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_bwd_cuda_wrapper_refuses_cpu_tensors():
    u, W, b, dvs = (torch.from_numpy(x) for x in _problem())
    vs = routing.sequential_routing(u, W, b, 1, True)
    launches = sequential_routing_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        sequential_routing_bwd_cuda(u, W, b, vs, dvs, True)
    assert sequential_routing_bwd_cuda.launches == launches


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor was sent to a CUDA kernel")

    monkeypatch.setattr(routing_cuda, "sequential_routing_cuda", refuse)
    monkeypatch.setattr(routing_cuda, "sequential_routing_bwd_cuda", refuse)
    u, W, b, dvs = _problem(seed=4)
    for num_iter in (1, 2):
        inputs = [torch.from_numpy(x).requires_grad_() for x in (u, W, b)]
        plain_backwards = SDRFunction.plain_backwards
        out = routing.route_layer(*inputs, num_iter, is_context=True,
                                  is_last_layer=True)
        out.backward(torch.from_numpy(dvs))
        # only num_iter chooses the autograd-through-the-loop backward
        assert SDRFunction.plain_backwards - plain_backwards == (num_iter > 1)
        assert all(x.grad is not None for x in inputs)


def test_inference_mode_forward_saves_no_graph():
    u, W, b, _ = (torch.from_numpy(x) for x in _problem(seed=5))
    with torch.inference_mode():
        got = routing.route_layer(u, W, b, 1, is_context=True,
                                  is_last_layer=False)
    assert not got.requires_grad
    assert torch.equal(got, routing.sequential_routing(u, W, b, 1, False))
