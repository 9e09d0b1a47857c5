"""The port's plain routing against srf_tpu: the SDR loop against the JAX
scan (materialized and factored bodies) and against the Pallas kernel K1 in
interpret mode, and DR against DR. Tolerance rtol 1e-4 / atol 1e-5: the
same float32 math with sums taken in another order. Also: the K1 wrapper
refuses CPU tensors and route_layer never hands it one."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.ops import routing as jax_routing
from srf_tpu.ops.routing_pallas import sequential_routing_pallas
from srf_tpu_torch.ops import routing, routing_cuda
from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _problem(seed=0, B=3, T=7, in_n=6, in_d=4, out_n=5, out_d=3):
    rng = np.random.RandomState(seed)
    u = rng.randn(B, T, in_n, in_d).astype(np.float32)
    W = (rng.randn(in_n, out_n, out_d, in_d) * 0.3).astype(np.float32)
    b = (rng.randn(in_n, out_n, out_d) * 0.1).astype(np.float32)
    return u, W, b


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("num_iter,mask", [(1, True), (1, False), (2, True),
                                           (2, False)])
def test_sdr_matches_jax_scan(num_iter, mask, factored):
    u, W, b = _problem(B=3)  # B not a multiple of 8
    want = jax_routing.sequential_routing(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b), num_iter, mask,
        factored=factored)
    got = routing.sequential_routing(*_torch(u, W, b), num_iter, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_sdr_v_init_and_step_valid():
    u, W, b = _problem(seed=1, B=2, T=5)
    v0 = np.random.RandomState(2).randn(2, 5, 3).astype(np.float32) * 0.3
    valid = np.array([False, True, True, False, True])
    want = jax_routing.sequential_routing(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b), 2, True,
        v_init=jnp.asarray(v0), step_valid=jnp.asarray(valid))
    got = routing.sequential_routing(
        *_torch(u, W, b), 2, True, v_init=torch.from_numpy(v0),
        step_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (2, False)])
def test_sdr_matches_pallas_k1_interpret(num_iter, mask):
    u, W, b = _problem(seed=3, B=2, T=6)
    want = sequential_routing_pallas(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b), num_iter, mask)
    got = routing.sequential_routing(*_torch(u, W, b), num_iter, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (3, False)])
def test_dr_matches_jax(num_iter, mask):
    u, W, b = _problem(seed=4, B=3, T=4)
    u_hat_jax = jax_routing.predict_capsules(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b))
    u_hat = routing.predict_capsules(*_torch(u, W, b))
    np.testing.assert_allclose(u_hat.numpy(), np.asarray(u_hat_jax),
                               rtol=RTOL, atol=ATOL)
    want = jax_routing.dynamic_routing(u_hat_jax, num_iter, mask)
    got = routing.dynamic_routing(u_hat, num_iter, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    got = routing.route_layer(*_torch(u, W, b), num_iter, is_context=False,
                              is_last_layer=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    u, W, b = _torch(*_problem())
    launches = sequential_routing_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        sequential_routing_cuda(u, W, b, 1, True)
    assert sequential_routing_cuda.launches == launches


def test_route_layer_keeps_cpu_tensors_off_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("route_layer sent a CPU tensor to the kernel")

    monkeypatch.setattr(routing_cuda, "sequential_routing_cuda", refuse)
    u, W, b = _torch(*_problem())
    got = routing.route_layer(u, W, b, 1, is_context=True, is_last_layer=True)
    want = routing.sequential_routing(u, W, b, 1, True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="iter >= 1"):
        routing.route_layer(u, W, b, 0, is_context=True, is_last_layer=True)
