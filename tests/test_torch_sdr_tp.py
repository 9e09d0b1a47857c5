"""K1-tp's and K2-tp's kernels (``srf_tpu_torch/csrc/sdr_tp.cu``) on the
CPU: the source built as host C++ (``tests/_sdr_tp_host.h``: a block's
threads as std::threads, its barriers std::barriers, a cooperative
launch's blocks all at once), against the plain SDR on the whole W
(``ops/routing.py``): each shard's output and the global (M, L) within
1e-5, du (summed over the shards) and each shard's dW and db within 1e-4
of their largest entry.

- The host loop's step kernels, driven by the wrappers' own loops over
  time (``routing_cuda.tp_forward_steps`` and ``tp_backward_steps``), 2 or
  3 shards in lockstep with the exchange done here.
- The persistent kernels (``routing_cuda.tp_forward_persistent`` and
  ``tp_backward_persistent``) as a co-launch of every shard, exchanging
  through flags in the buffers of ``routing_cuda.new_local_exchange``, on
  the general path (out_d 3) and the register paths (out_d 8 and 20); two
  calls in a row on the same buffers (the epochs); a co-launch whose last
  rank never runs times out and raises.
- The status words' check: a launch's timeout raised once its launch has
  ended, and not before (on the card the check waits for nothing).
- The transport as a function of the ranks' hosts and cards, a group's
  own timeout as transport 2's deadline, the co-launch's plain versions,
  and the wrappers' checks and refusals on CPU tensors.

The prediction and weight-gradient kernels are K1's and K2's, held on the
card (``chip_smoke.py`` phases 3-4 and 17a); here their plain versions
stand in."""

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


def _inputs(seed, steps=STEPS, out_n=OUT_N, out_d=OUT_D):
    rng = np.random.RandomState(seed)
    u = rng.randn(BATCH, steps, IN_N, IN_D)
    wgt = 0.5 * rng.randn(IN_N, out_n, out_d, IN_D)
    bias = 0.1 * rng.randn(IN_N, out_n, out_d)
    cot = rng.randn(BATCH, steps, out_n, out_d)
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


def _persistent_call(lib, exchange, u, wgt, bias, cot, shards, pad,
                     num_iter):
    """The persistent K1-tp (and at one iteration K2-tp) as a co-launch of
    ``shards`` contiguous shards on ``exchange``; returns each shard's
    (part, out, stats) and, at one iteration, (du summed, [dW], [db])."""
    length = wgt.shape[1] // shards
    parts = [slice(q * length, (q + 1) * length) for q in range(shards)]
    uhats = [routing.predict_capsules_rows(u, wgt[:, p], bias[:, p])
             .contiguous() for p in parts]
    pad_rank = 0 if pad else -1
    outs, stats = routing_cuda.tp_forward_persistent(
        lib, uhats, length, wgt.shape[2], num_iter,
        pad_rank, exchange, 0, None)
    forward = list(zip(parts, outs, stats))
    if num_iter > 1:
        return forward, None
    factors = routing_cuda.tp_backward_persistent(
        lib, uhats, outs,
        [cot[:, :, p].contiguous() for p in parts], stats, pad_rank,
        exchange, 0, None)
    du_sum, dws, dbs = 0, [], []
    for (c, da, ds), out, part in zip(factors, outs, parts):
        ds = ds.reshape(out.shape)
        du_q, dw_q, db_q = routing.sdr_weight_grads(u, wgt[:, part], out, c,
                                                    da, ds)
        du_sum = du_sum + du_q
        dws.append(dw_q)
        dbs.append(db_q)
    return forward, (du_sum, dws, dbs)


def _hold(u, wgt, bias, cot, pad, num_iter, forward, grads):
    """The persistent kernels' results against the plain SDR on the whole
    W."""
    want, want_stats = routing.sequential_routing_tp(
        u, wgt, bias, num_iter, pad, None, return_stats=True)
    for part, out, stats in forward:
        np.testing.assert_allclose(out, want[:, :, part], rtol=0, atol=1e-5)
        np.testing.assert_allclose(stats, want_stats, rtol=1e-5, atol=1e-5)
    if grads is None:
        return
    du, dwgt, dbias = routing.sequential_routing_bwd(u, wgt, bias, want, cot,
                                                     pad)
    du_sum, dws, dbs = grads
    for (part, _, _), dw_q, db_q in zip(forward, dws, dbs):
        for got, ref in ((dw_q, dwgt[:, part]), (db_q, dbias[:, part])):
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * ref.abs().max())
    np.testing.assert_allclose(du_sum, du, rtol=0, atol=1e-4 * du.abs().max())


@pytest.mark.parametrize("shards,pad,num_iter", [
    (2, True, 1), (2, False, 1), (3, True, 1), (2, True, 2), (3, False, 2)])
def test_persistent_kernels_match_the_plain_sdr(host_lib, shards, pad,
                                                num_iter):
    """The general path (out_d 3: warp_pass_rows), the existing cases."""
    u, wgt, bias, cot = _inputs(7 + shards + num_iter)
    exchange = routing_cuda.new_local_exchange(shards, BATCH * IN_N, "cpu")
    forward, grads = _persistent_call(host_lib, exchange, u, wgt, bias, cot,
                                      shards, pad, num_iter)
    _hold(u, wgt, bias, cot, pad, num_iter, forward, grads)


@pytest.mark.parametrize("shards,pad,num_iter,out_n,out_d", [
    (2, True, 1, 12, 8), (3, False, 2, 9, 8), (2, True, 1, 80, 8),
    (2, True, 1, 4, 20), (3, True, 2, 6, 20)])
def test_persistent_register_paths_match_the_plain_sdr(
        host_lib, shards, pad, num_iter, out_n, out_d):
    """The register path (warp_pass_lanes) at the recipes' capsule dims, 8
    (SRF-TIMIT; 40 capsules a shard take two a lane, and K2-tp one row a
    warp) and 20 (SRF-WSJ)."""
    u, wgt, bias, cot = _inputs(3 + out_d + num_iter, out_n=out_n,
                                out_d=out_d)
    exchange = routing_cuda.new_local_exchange(shards, BATCH * IN_N, "cpu")
    forward, grads = _persistent_call(host_lib, exchange, u, wgt, bias, cot,
                                      shards, pad, num_iter)
    _hold(u, wgt, bias, cot, pad, num_iter, forward, grads)


def test_two_calls_on_the_same_buffers_give_the_second_answer(host_lib):
    """The flags are never cleared: a second call (other inputs, fewer
    steps) on the same buffers waits for its own epochs, after the first
    call's, and gives its own answer."""
    exchange = routing_cuda.new_local_exchange(2, BATCH * IN_N, "cpu")
    first = _inputs(21)
    _persistent_call(host_lib, exchange, *first, 2, True, 1)
    assert exchange.epochs == 2 * STEPS  # a forward's and a backward's
    u, wgt, bias, cot = _inputs(22, steps=STEPS - 1)
    forward, grads = _persistent_call(host_lib, exchange, u, wgt, bias, cot,
                                      2, True, 1)
    assert exchange.epochs == 2 * STEPS + 2 * (STEPS - 1)
    _hold(u, wgt, bias, cot, True, 1, forward, grads)


def test_a_rank_that_never_runs_times_out_and_raises(host_lib):
    """A co-launch of ranks 0 and 1 of a set of 3: their waits for rank 2
    end at the deadline, the status words name the rank, utterance, step
    and epoch, and the wrapper raises (no hang); the status is cleared."""
    import time

    u, wgt, bias, _ = _inputs(5)
    uhats = [routing.predict_capsules_rows(u, wgt[:, 2 * q:2 * q + 2],
                                           bias[:, 2 * q:2 * q + 2])
             .contiguous() for q in range(2)]
    timeout = 0.5
    exchange = routing_cuda.new_local_exchange(3, BATCH * IN_N, "cpu")
    exchange.timeout_s = timeout
    start = time.perf_counter()
    with pytest.raises(RuntimeError, match=(
            r"K1-tp: rank [01] waited more than 0.5 s for rank 2's exchange "
            r"of utterance [01], step 0, iteration 0 \(epoch 1\)")):
        routing_cuda.tp_forward_persistent(host_lib, uhats, 2, OUT_D, 1, 0,
                                           exchange, 0, None)
    elapsed = time.perf_counter() - start
    assert timeout <= elapsed < timeout + 10.0
    assert not exchange.status.any() and not exchange.pending


class _Launch:
    """A launch's end as a CUDA event shows it: ``query`` until it has
    ended, ``synchronize`` ends it."""

    def __init__(self):
        self.ended = False

    def query(self):
        return self.ended

    def synchronize(self):
        self.ended = True


def test_a_timeout_is_raised_once_its_launch_has_ended():
    """The status words of a launch on the card are read once the launch
    has ended: a later call's check passes over a launch still running,
    and raises, naming it, once it has ended; ``wait`` waits for it."""
    exchange = routing_cuda.new_local_exchange(2, BATCH * IN_N, "cpu")
    failed = torch.tensor([1, 1, 0, 3, 0, 7, 0, 0])
    for wait in (False, True):
        clean, running = _Launch(), _Launch()
        clean.ended = True
        exchange.pending = [(clean, torch.zeros(8, dtype=torch.int64),
                             "K1-tp"), (running, failed, "K2-tp")]
        routing_cuda.check_exchange(exchange)
        assert exchange.pending == [(running, failed, "K2-tp")]
        running.ended = not wait
        with pytest.raises(RuntimeError, match=(
                r"K2-tp: rank 1 waited more than 10.0 s for rank 0's "
                r"exchange of utterance 0, step 3, iteration 0 \(epoch 7\)")):
            routing_cuda.check_exchange(exchange, wait=wait)
        assert running.ended and not exchange.pending


def test_transport_2_waits_as_long_as_the_group(tmp_path):
    """Transport 2's deadline is the group's own timeout, which its
    collectives wait for a peer."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://%s" % (
        tmp_path / "store"), world_size=1, rank=0)
    try:
        group = dist.new_group([0], timeout=datetime.timedelta(seconds=77))
        assert routing_cuda.group_timeout_s(group, torch.device("cpu")) == 77
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("peers,want", [
    ([("h0", "GPU-a")], "host_loop"),
    ([("h0", "GPU-a"), ("h0", "GPU-b")], "ipc"),
    ([("h0", "GPU-%d" % q) for q in range(4)], "ipc"),
    ([("h0", "GPU-a"), ("h0", "GPU-a")], "host_loop"),
    ([("h0", "GPU-a"), ("h1", "GPU-b")], "host_loop"),
    ([("h0", "GPU-a"), ("h0", "GPU-b"), ("h1", "GPU-c")], "host_loop"),
    ([("h0", "GPU-%d" % q) for q in range(routing_cuda.TP_MAX_RANKS + 1)],
     "host_loop"),
], ids=["one_rank", "two_cards", "four_cards", "shared_card", "two_hosts",
        "mixed", "too_many"])
def test_the_transport_follows_the_topology(peers, want):
    assert routing_cuda.choose_transport(peers) == want


def test_a_group_of_one_rank_takes_the_host_loop():
    """A rank alone (no ``model`` group) runs the host loop, which has no
    exchange; the co-launch is reached only through its own wrappers."""
    assert routing_cuda.tp_transport(None) == "host_loop"


@pytest.mark.parametrize("shards,pad", [(2, True), (3, False)])
def test_the_colaunch_plain_versions_match_the_plain_sdr(shards, pad):
    """The co-launch's plain versions (the card's reference for it) are the
    plain SDR on the whole W, split by shard."""
    u, wgt, bias, cot = _inputs(11 + shards)
    length = OUT_N // shards
    parts = [slice(q * length, (q + 1) * length) for q in range(shards)]
    wgts, biases = [wgt[:, p] for p in parts], [bias[:, p] for p in parts]
    outs, statss = routing.sequential_routing_tp_colaunch(u, wgts, biases, 1,
                                                          pad)
    want = routing.sequential_routing(u, wgt, bias, 1, pad)
    np.testing.assert_allclose(torch.cat(outs, dim=2), want, rtol=0,
                               atol=1e-6)
    du, dws, dbs = routing.sequential_routing_tp_bwd_colaunch(
        u, wgts, biases, outs, [cot[:, :, p] for p in parts], statss, pad)
    ref = routing.sequential_routing_bwd(u, wgt, bias, want, cot, pad)
    for got, exp in zip((du, torch.cat(dws, dim=1), torch.cat(dbs, dim=1)),
                        ref):
        np.testing.assert_allclose(got, exp, rtol=0,
                                   atol=1e-5 * exp.abs().max())


def test_the_colaunch_wrappers_take_cuda_tensors_only():
    u, wgt, bias, cot = _inputs(4)
    with pytest.raises(ValueError,
                       match="ops.routing.sequential_routing_tp_colaunch"):
        routing_cuda.sequential_routing_tp_colaunch_cuda(
            u, [wgt[:, :3], wgt[:, 3:]], [bias[:, :3], bias[:, 3:]], 1, True)
    stats = torch.zeros(STEPS, 1, BATCH, IN_N, 2)
    with pytest.raises(
            ValueError, match="ops.routing.sequential_routing_tp_bwd_colaunch"):
        routing_cuda.sequential_routing_tp_bwd_colaunch_cuda(
            u, [wgt], [bias], [cot], [cot], [stats], True)
