"""K1-tp's and K2-tp's step kernels (``srf_tpu_torch/csrc/sdr_tp.cu``) on
the CPU: the source built as host C++ (``tests/_sdr_tp_host.h``: a block's
threads as std::threads, its barrier a std::barrier) and driven by the
wrappers' own loops over time (``routing_cuda.tp_forward_steps`` and
``tp_backward_steps``), 2 or 3 shards in lockstep with the exchange done
here, against the plain SDR on the whole W (``ops/routing.py``): each
shard's output and the global (M, L) within 1e-5, du (summed over the
shards) and each shard's dW and db within 1e-4 of their largest entry.
The prediction and weight-gradient kernels are K1's and K2's, held on the
card (``chip_smoke.py`` phases 3-4 and 17a); here their plain versions
stand in. The wrappers' checks and refusals on CPU tensors, too."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from srf_tpu_torch.ops import routing, routing_cuda

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "srf_tpu_torch", "csrc",
                      "sdr_tp.cu")
BATCH, STEPS, IN_N, OUT_N, OUT_D, IN_D = 2, 4, 5, 6, 3, 2


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """sdr_tp.cu built with g++ as host C++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build csrc/sdr_tp.cu for the CPU")
    path = str(tmp_path_factory.mktemp("sdr_tp") / "libsdr_tp_host.so")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-x", "c++", "-DSDR_TP_HOST", "-include",
                    os.path.join(HERE, "_sdr_tp_host.h"), SOURCE, "-o", path],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(path)
    routing_cuda.declare_tp(lib)
    return lib


def _inputs(seed):
    rng = np.random.RandomState(seed)
    u = rng.randn(BATCH, STEPS, IN_N, IN_D)
    wgt = 0.5 * rng.randn(IN_N, OUT_N, OUT_D, IN_D)
    bias = 0.1 * rng.randn(IN_N, OUT_N, OUT_D)
    cot = rng.randn(BATCH, STEPS, OUT_N, OUT_D)
    return [torch.tensor(x, dtype=torch.float32) for x in (u, wgt, bias, cot)]


def lockstep(steps, exchange):
    """Run one generator per shard together; ``exchange`` maps the list of
    their yields to the list of what each is sent. Returns their results."""
    sent = [next(g) for g in steps]
    while True:
        answers = exchange(sent)
        sent, results = [], []
        for g, answer in zip(steps, answers):
            try:
                sent.append(g.send(answer))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            assert len(results) == len(steps)
            return results


@pytest.mark.parametrize("shards,pad,num_iter", [
    (2, True, 1), (2, False, 1), (3, True, 1), (2, True, 2), (3, False, 2)])
def test_step_kernels_match_the_plain_sdr(host_lib, shards, pad, num_iter):
    u, wgt, bias, cot = _inputs(7 + shards + num_iter)
    want, want_stats = routing.sequential_routing_tp(
        u, wgt, bias, num_iter, pad, None, return_stats=True)
    np.testing.assert_allclose(
        want, routing.sequential_routing(u, wgt, bias, num_iter, pad),
        rtol=0, atol=1e-6)
    length = OUT_N // shards
    parts = [slice(q * length, (q + 1) * length) for q in range(shards)]
    uhats = [routing.predict_capsules_rows(u, wgt[:, p], bias[:, p])
             for p in parts]
    forward = lockstep(
        [routing_cuda.tp_forward_steps(host_lib, uhat, length, OUT_D,
                                       num_iter, pad and q == 0, None)
         for q, uhat in enumerate(uhats)],
        lambda pairs: [torch.stack(pairs)] * shards)
    for (out, stats), part in zip(forward, parts):
        np.testing.assert_allclose(out, want[:, :, part], rtol=0, atol=1e-5)
        np.testing.assert_allclose(stats, want_stats, rtol=1e-5, atol=1e-5)
    if num_iter > 1:
        return
    du, dwgt, dbias = routing.sequential_routing_bwd(u, wgt, bias, want, cot,
                                                     pad)
    factors = lockstep(
        [routing_cuda.tp_backward_steps(
            host_lib, uhat, out.contiguous(), cot[:, :, part].contiguous(),
            stats, pad and q == 0, None)
         for q, (uhat, (out, stats), part) in enumerate(zip(uhats, forward,
                                                            parts))],
        lambda rows: [sum(rows)] * shards)
    du_sum = 0
    for (c, da, ds), (out, _), part in zip(factors, forward, parts):
        ds = ds.reshape(BATCH, STEPS, length, OUT_D)
        du_q, dw_q, db_q = routing.sdr_weight_grads(
            u, wgt[:, part], out, c, da, ds)
        du_sum = du_sum + du_q
        for got, ref in ((dw_q, dwgt[:, part]), (db_q, dbias[:, part])):
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * ref.abs().max())
    np.testing.assert_allclose(du_sum, du, rtol=0, atol=1e-4 * du.abs().max())


def test_the_wrappers_take_cuda_tensors_only():
    u, wgt, bias, cot = _inputs(1)
    with pytest.raises(ValueError, match="ops.routing.sequential_routing_tp"):
        routing_cuda.sequential_routing_tp_cuda(u, wgt, bias, 1, True, None)
    stats = torch.zeros(STEPS, 1, BATCH, IN_N, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        routing_cuda.sequential_routing_tp_bwd_cuda(u, wgt, bias, cot, cot,
                                                    stats, True, None)


def test_the_split_backward_refuses_a_deeper_forward():
    """The one-iteration backward refuses a two-iteration forward's stats
    (its first iteration's (M, L) would give a wrong gradient)."""
    u, wgt, bias, cot = _inputs(3)
    out, stats = routing.sequential_routing_tp(u, wgt, bias, 2, True, None,
                                               return_stats=True)
    with pytest.raises(ValueError, match="one routing iteration"):
        routing.sequential_routing_tp_bwd(u, wgt, bias, out, cot, True, None,
                                          stats)


def test_sdr_tp_function_runs_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors ``SDRTPFunction`` never reaches the kernels: one
    iteration's backward is the plain split backward, two iterations'
    autograd through the plain loop (counted)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    monkeypatch.setattr(routing_cuda, "sequential_routing_tp_cuda", refuse)
    monkeypatch.setattr(routing_cuda, "sequential_routing_tp_bwd_cuda",
                        refuse)
    u, wgt, bias, cot = _inputs(2)
    for num_iter in (1, 2):
        before = routing_cuda.SDRTPFunction.plain_backwards
        leaves = [x.clone().requires_grad_() for x in (u, wgt, bias)]
        out = routing.route_layer(*leaves, num_iter, True, True,
                                  shard=(0, OUT_N, None))
        (out * cot).sum().backward()
        ref = [x.clone().requires_grad_() for x in (u, wgt, bias)]
        (routing.sequential_routing(*ref, num_iter, True) * cot).sum(
            ).backward()
        for got, want in zip(leaves, ref):
            np.testing.assert_allclose(got.grad, want.grad, rtol=0,
                                       atol=1e-4 * want.grad.abs().max())
        assert routing_cuda.SDRTPFunction.plain_backwards - before == (
            num_iter > 1)
