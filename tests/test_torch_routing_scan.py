"""The port's counterpart of ``sequential_routing_pallas_scan`` against
srf_tpu: ``sequential_routing_scan`` and ``SDRScanFunction`` on the CPU
(the plain versions of K3 and K4) against the JAX function, which runs the
Pallas K3 (``_sdr_v6_fwd_kernel``) and, for one routing iteration, K4
(``_sdr_v6_bwd_kernel``) in interpret mode. B=3 is not a multiple of the
Pallas kernels' batch padding (8) and T=11 not a multiple of any
``time_block`` tried, so padding is exercised on the JAX side. Forward
tolerance rtol 1e-4 / atol 1e-5 (the same float32 math, sums in another
order; measured ~2e-7); gradients rtol 1e-4 / atol 1e-5 as in
``test_torch_routing_bwd.py`` (measured 1.9e-6). Also: float64
gradcheck, the K3/K4 wrappers refuse CPU tensors, a CPU forward and
backward never reach a kernel, and ``time_block < 1`` raises.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops.routing_pallas import sequential_routing_pallas_scan
from srf_tpu_torch.ops import routing, routing_cuda
from srf_tpu_torch.ops.routing_cuda import (SDRScanFunction,
                                            sequential_routing_scan,
                                            sequential_routing_scan_bwd_cuda,
                                            sequential_routing_scan_cuda)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _problem(seed=0, B=3, T=11, in_n=6, in_d=4, out_n=5, out_d=3):
    """u, W, b and a cotangent dvs, from a numpy seed."""
    rng = np.random.RandomState(seed)
    u = rng.randn(B, T, in_n, in_d).astype(np.float32)
    W = (rng.randn(in_n, out_n, out_d, in_d) * 0.3).astype(np.float32)
    b = (rng.randn(in_n, out_n, out_d) * 0.1).astype(np.float32)
    dvs = rng.randn(B, T, out_n, out_d).astype(np.float32)
    return u, W, b, dvs


@pytest.mark.parametrize("num_iter", [1, 2])
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("time_block", [8, 4, 1])
def test_forward_matches_pallas_k3_interpret(time_block, mask, num_iter):
    u, W, b, _ = _problem(seed=time_block)
    want = sequential_routing_pallas_scan(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b), num_iter, mask,
        time_block)
    got = sequential_routing_scan(*(torch.from_numpy(x) for x in (u, W, b)),
                                  num_iter, mask, time_block)
    assert got.shape == (3, 11, 5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (1, False), (2, True)])
def test_gradients_match_jax_grad_through_pallas_scan(num_iter, mask):
    u, W, b, dvs = _problem(seed=10 + num_iter)
    time_block = 4

    def loss(u_, w_, b_):
        out = sequential_routing_pallas_scan(u_, w_, b_, num_iter, mask,
                                             time_block)
        return jnp.sum(out * jnp.asarray(dvs))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(W), jnp.asarray(b))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (u, W, b)]
    plain_backwards = SDRScanFunction.plain_backwards
    sequential_routing_scan(*inputs, num_iter, mask, time_block).backward(
        torch.from_numpy(dvs))
    assert SDRScanFunction.plain_backwards - plain_backwards == (num_iter > 1)
    for name, x, w in zip(("du", "dW", "db"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("num_iter,mask", [(1, True), (1, False), (2, False)])
def test_sdr_scan_function_gradcheck_float64(num_iter, mask):
    u, W, b, _ = _problem(seed=20, B=2, T=5, in_n=4, in_d=3, out_n=3, out_d=2)
    inputs = tuple(torch.from_numpy(x).double().requires_grad_()
                   for x in (u, W, b))
    assert torch.autograd.gradcheck(
        lambda *x: SDRScanFunction.apply(*x, num_iter, mask, 2), inputs)


def test_scan_cuda_wrappers_refuse_cpu_tensors():
    u, W, b, dvs = (torch.from_numpy(x) for x in _problem(seed=30))
    vs = routing.sequential_routing(u, W, b, 1, True)
    launches = (sequential_routing_scan_cuda.launches,
                sequential_routing_scan_bwd_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors.*sequential_routing$"):
        sequential_routing_scan_cuda(u, W, b, 1, True)
    with pytest.raises(ValueError,
                       match="CUDA tensors.*sequential_routing_bwd$"):
        sequential_routing_scan_bwd_cuda(u, W, b, vs, dvs, True)
    assert (sequential_routing_scan_cuda.launches,
            sequential_routing_scan_bwd_cuda.launches) == launches


def test_cpu_tensors_never_reach_the_scan_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor was sent to a CUDA kernel")

    for name in ("sequential_routing_scan_cuda",
                 "sequential_routing_scan_bwd_cuda", "sequential_routing_cuda",
                 "sequential_routing_bwd_cuda"):
        monkeypatch.setattr(routing_cuda, name, refuse)
    u, W, b, dvs = _problem(seed=31)
    launches = (sequential_routing_scan_cuda.launches,
                sequential_routing_scan_bwd_cuda.launches)
    for num_iter in (1, 2):
        inputs = [torch.from_numpy(x).requires_grad_() for x in (u, W, b)]
        out = routing_cuda.sequential_routing_scan(*inputs, num_iter, True)
        out.backward(torch.from_numpy(dvs))
        assert all(x.grad is not None for x in inputs)
    assert (sequential_routing_scan_cuda.launches,
            sequential_routing_scan_bwd_cuda.launches) == launches


@pytest.mark.parametrize("time_block", [0, -1])
def test_time_block_below_one_raises(time_block):
    u, W, b, _ = (torch.from_numpy(x) for x in _problem(seed=32))
    with pytest.raises(ValueError, match="time_block >= 1"):
        sequential_routing_scan(u, W, b, 1, False, time_block)
    with pytest.raises(ValueError, match="time_block >= 1"):
        SDRScanFunction.apply(u, W, b, 2, True, time_block)
