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
    # every card can map every other as a peer
    reach = {card: {other for _, other in peers if other != card}
             for _, card in peers}
    assert routing_cuda.choose_transport(peers, reach) == want


@pytest.mark.parametrize("reach,want", [
    ({"GPU-a": {"GPU-b"}, "GPU-b": {"GPU-a"}}, "ipc"),
    ({"GPU-a": {"GPU-b"}, "GPU-b": set()}, "host_loop"),
    ({"GPU-a": set(), "GPU-b": set()}, "host_loop"),
], ids=["peer_access", "one_way", "no_peer_access"])
def test_cards_without_peer_access_take_the_host_loop(reach, want):
    """CUDA IPC maps a peer's flags only where the cards have peer access:
    two cards of one host without it take the host loop."""
    peers = [("h0", "GPU-a"), ("h0", "GPU-b")]
    assert routing_cuda.choose_transport(peers, reach) == want


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


# ---- K1-tp-bf16, K2-tp-bf16 and K1-tp-stream on the host build

# bf16: the kernels against the plain split bf16 SDR, whose float32 sums
# run in another order, so a sum may round a c, a v or a dc to the other
# bf16 neighbour: outputs, the (M, L) statistics and du_hat's factors
# within BF16_FWD_REL of their largest entry (measured below 1e-6 here,
# where the float32 SDR reads 3e-3 to 1.4e-2 from the bf16 one), the
# gradients within BF16_BWD_REL (K2-bf16's limit on the card, 4 bf16
# ulps, chip_smoke.py)
BF16_FWD_REL, BF16_BWD_REL = 1e-3, 1.6e-2


def _bf16(*tensors):
    return [x.to(torch.bfloat16) for x in tensors]


def _bf16_weight_grads(u, wgt, vs, c, da, ds):
    """(du, dW, db) from a bf16 forward's factors, rounded where the
    bf16 weight-gradient kernel rounds (du_hat = bf16(bf16(c) ds + da
    bf16(v_{t-1}))), float32 sums; u and wgt bf16."""
    rnd = routing.round_bf16
    v_prev = torch.cat([torch.zeros_like(vs[:, :1]), vs[:, :-1]], dim=1)
    du_hat = rnd(rnd(c)[..., None] * ds[:, :, None]
                 + da[..., None] * rnd(v_prev)[:, :, None])
    uf, wf = u.float(), wgt.float()
    return (torch.einsum("btnoi,noij->btnj", du_hat, wf),
            torch.einsum("btnoi,btnj->noij", du_hat, uf),
            du_hat.sum(dim=(0, 1)))


def _hold_rel(got, want, rel, name):
    limit = rel * want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= limit, "%s: %.3e > %.3e" % (name, err, limit)


def _hold_bf16(u, wgt, bias, cot, pad, num_iter, forward, grads):
    """The bf16 kernels' results against the plain split bf16 SDR on the
    whole W (group None: the softmax over every shard): outputs,
    statistics, du_hat's factors shard by shard, and the gradients."""
    want, want_stats = routing.sequential_routing_tp(
        u, wgt, bias, num_iter, pad, None, return_stats=True, bf16=True)
    for part, out, stats in forward:
        _hold_rel(out, want[:, :, part], BF16_FWD_REL, "out")
        np.testing.assert_allclose(stats, want_stats, rtol=BF16_FWD_REL,
                                   atol=1e-6)
    if grads is None:
        return
    u_hat = routing.predict_capsules_bf16(*_bf16(u, wgt, bias)).float()
    whole = routing.sequential_routing_tp_bwd_factors(
        u_hat, want, cot, pad, None, want_stats, bf16=True)
    for (part, _, _), factors in zip(forward, grads[3]):
        for name, got, ref in zip(("c", "da", "ds"), factors,
                                  (whole[0][..., part], whole[1][..., part],
                                   whole[2][:, :, part])):
            _hold_rel(got.reshape(ref.shape), ref, BF16_FWD_REL, name)
    du, dwgt, dbias = routing.sequential_routing_tp_bwd_bf16(
        u, wgt, bias, cot, pad, None)
    du_sum, dws, dbs, _ = grads
    for (part, _, _), dw_q, db_q in zip(forward, dws, dbs):
        _hold_rel(dw_q, dwgt[:, part], BF16_BWD_REL, "dW")
        _hold_rel(db_q, dbias[:, part], BF16_BWD_REL, "db")
    _hold_rel(du_sum, du, BF16_BWD_REL, "du")


@pytest.mark.parametrize("shards,pad,num_iter", [
    (2, True, 1), (3, False, 1), (2, False, 2)])
def test_bf16_step_kernels_match_the_plain_split_bf16(host_lib, shards, pad,
                                                      num_iter):
    """The host loop's step kernels' bf16 instances, 2-3 shards in
    lockstep, on the bf16 prediction's rows (pitch 8)."""
    u, wgt, bias, cot = _inputs(31 + shards + num_iter)
    length = OUT_N // shards
    parts = [slice(q * length, (q + 1) * length) for q in range(shards)]
    ub, wb, bb = _bf16(u, wgt, bias)
    uhats = [routing.predict_capsules_rows(ub, wb[:, p].contiguous(),
                                           bb[:, p].contiguous())
             for p in parts]
    assert uhats[0].dtype == torch.bfloat16 and uhats[0].shape[-1] % 8 == 0
    forward = lockstep(
        [routing_cuda.tp_forward_steps(host_lib, uhat, length, OUT_D,
                                       num_iter, pad and q == 0, None)
         for q, uhat in enumerate(uhats)],
        lambda pairs: [torch.stack(pairs)] * shards)
    grads = None
    if num_iter == 1:
        factors = lockstep(
            [routing_cuda.tp_backward_steps(
                host_lib, uhat, out.contiguous(),
                cot[:, :, part].contiguous(), stats, pad and q == 0, None)
             for q, (uhat, (out, stats), part) in enumerate(
                 zip(uhats, forward, parts))],
            lambda rows: [sum(rows)] * shards)
        du_sum, dws, dbs = 0, [], []
        for (c, da, ds), (out, _), part in zip(factors, forward, parts):
            du_q, dw_q, db_q = _bf16_weight_grads(
                ub, wb[:, part], out, c, da, ds.reshape(out.shape))
            du_sum = du_sum + du_q
            dws.append(dw_q)
            dbs.append(db_q)
        grads = (du_sum, dws, dbs, factors)
    _hold_bf16(u, wgt, bias, cot, pad, num_iter,
               [(part, out, stats) for (out, stats), part in zip(forward,
                                                                 parts)],
               grads)


def _persistent_bf16(lib, exchange, u, wgt, bias, cot, shards, pad,
                     num_iter):
    """_persistent_call's bf16 counterpart: bf16 rows into the persistent
    kernels' bf16 instances."""
    length = wgt.shape[1] // shards
    parts = [slice(q * length, (q + 1) * length) for q in range(shards)]
    ub, wb, bb = _bf16(u, wgt, bias)
    uhats = [routing.predict_capsules_rows(ub, wb[:, p].contiguous(),
                                           bb[:, p].contiguous())
             .contiguous() for p in parts]
    pad_rank = 0 if pad else -1
    outs, stats = routing_cuda.tp_forward_persistent(
        lib, uhats, length, wgt.shape[2], num_iter, pad_rank, exchange, 0,
        None)
    forward = list(zip(parts, outs, stats))
    if num_iter > 1:
        return forward, None
    factors = routing_cuda.tp_backward_persistent(
        lib, uhats, outs, [cot[:, :, p].contiguous() for p in parts], stats,
        pad_rank, exchange, 0, None)
    du_sum, dws, dbs = 0, [], []
    for (c, da, ds), out, part in zip(factors, outs, parts):
        du_q, dw_q, db_q = _bf16_weight_grads(ub, wb[:, part], out, c, da,
                                              ds.reshape(out.shape))
        du_sum = du_sum + du_q
        dws.append(dw_q)
        dbs.append(db_q)
    return forward, (du_sum, dws, dbs, factors)


@pytest.mark.parametrize("shards,pad,num_iter,out_n,out_d", [
    (2, True, 1, 6, 3), (3, False, 2, 6, 3), (2, True, 1, 12, 8),
    (2, False, 1, 80, 8), (2, True, 1, 4, 20), (3, True, 2, 6, 20)])
def test_persistent_bf16_kernels_match_the_plain_split_bf16(
        host_lib, shards, pad, num_iter, out_n, out_d):
    """K1-tp-bf16 and K2-tp-bf16 as a co-launch: the general path (out_d
    3) and the register paths (out_d 8, two capsules a lane at 40 a shard,
    and 20), on a bf16 ring."""
    u, wgt, bias, cot = _inputs(41 + out_d + num_iter, out_n=out_n,
                                out_d=out_d)
    exchange = routing_cuda.new_local_exchange(shards, BATCH * IN_N, "cpu")
    forward, grads = _persistent_bf16(host_lib, exchange, u, wgt, bias, cot,
                                      shards, pad, num_iter)
    _hold_bf16(u, wgt, bias, cot, pad, num_iter, forward, grads)


def _stream_inputs(seed, out_n, out_d):
    """A nonzero carry before step 0 (the whole layer's) and a step mask
    whose first steps are warm-up on one row and none on the other."""
    rng = np.random.RandomState(seed)
    v_init = torch.tensor(0.3 * rng.randn(BATCH, out_n, out_d),
                          dtype=torch.float32)
    valid = torch.ones(BATCH, STEPS, dtype=torch.bool)
    valid[0, :2] = False
    return v_init, valid


@pytest.mark.parametrize("transport,shards,pad,num_iter,out_n,out_d", [
    ("host_loop", 2, True, 1, 6, 3), ("host_loop", 3, False, 2, 6, 3),
    ("persistent", 2, True, 1, 6, 3), ("persistent", 3, True, 2, 6, 3),
    ("persistent", 2, True, 1, 12, 8), ("persistent", 2, False, 1, 4, 20)])
def test_stream_kernels_take_a_carry_and_a_step_mask(
        host_lib, transport, shards, pad, num_iter, out_n, out_d):
    """K1-tp-stream, on both transports: each shard's carry from v_init,
    an invalid step's zeros in the output and the carry, against the plain
    split SDR's v_init / step_valid on the whole W (float32: K1-tp's
    limits, 1e-5), and v_last (the last step's output)."""
    u, wgt, bias, _ = _inputs(51 + num_iter, out_n=out_n, out_d=out_d)
    v_init, valid = _stream_inputs(52, out_n, out_d)
    want, want_stats = routing.sequential_routing_tp(
        u, wgt, bias, num_iter, pad, None, return_stats=True, v_init=v_init,
        step_valid=valid)
    np.testing.assert_allclose(
        want, routing.sequential_routing(u, wgt, bias, num_iter, pad,
                                         v_init, valid), rtol=0, atol=1e-6)
    length = out_n // shards
    parts = [slice(q * length, (q + 1) * length) for q in range(shards)]
    uhats = [routing.predict_capsules_rows(u, wgt[:, p], bias[:, p])
             .contiguous() for p in parts]
    v_inits = [v_init[:, p].contiguous() for p in parts]
    if transport == "host_loop":
        results = lockstep(
            [routing_cuda.tp_forward_steps(host_lib, uhat, length, out_d,
                                           num_iter, pad and q == 0, None,
                                           v_inits[q], valid)
             for q, uhat in enumerate(uhats)],
            lambda pairs: [torch.stack(pairs)] * shards)
    else:
        exchange = routing_cuda.new_local_exchange(shards, BATCH * IN_N,
                                                   "cpu")
        results = list(zip(*routing_cuda.tp_forward_persistent(
            host_lib, uhats, length, out_d, num_iter, 0 if pad else -1,
            exchange, 0, None, v_inits, valid)))
    for (out, stats), part in zip(results, parts):
        np.testing.assert_allclose(out, want[:, :, part], rtol=0, atol=1e-5)
        np.testing.assert_allclose(stats, want_stats, rtol=1e-5, atol=1e-5)
        assert not out[0, :2].any()  # the warm-up steps emit zeros
        np.testing.assert_allclose(out[:, -1], want[:, -1, part], rtol=0,
                                   atol=1e-5)
    # the carry moved the answer: without it the first row's steps differ
    zero = routing.sequential_routing_tp(u, wgt, bias, num_iter, pad, None,
                                         step_valid=valid)
    assert (zero[1] - want[1]).abs().max() > 1e-4
