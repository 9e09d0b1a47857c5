"""The traffic generators are deterministic in the seed, give every seed
the same work in another order, and match their mix files' shapes."""

import numpy as np
import pytest

from benchmark import harness, training
from benchmark.traffic import serve_open

TRAIN_CELLS = ("srf_wsj.train", "srf_timit.train")


def _ctx(cell, seed):
    return harness.load_context(cell, seed, 20.0, False)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_pools_follow_seed_and_mix(cell):
    ctx = _ctx(cell, 2**31 + 12345)
    traffic, cfg = ctx.traffic, ctx.model
    small = dict(traffic, pool=1)
    first = training.make_pools(small, ctx.family, cfg, ctx.seed)
    again = training.make_pools(small, ctx.family, cfg, ctx.seed)
    other = training.make_pools(small, ctx.family, cfg, ctx.seed + 1)
    for (batch, width, low, high), a, b, c in zip(traffic["buckets"], first,
                                                  again, other):
        assert a[0]["feats"].shape == (batch, width, cfg["feat_dim"])
        assert np.array_equal(a[0]["feats"], b[0]["feats"])
        assert not np.array_equal(a[0]["feats"], c[0]["feats"])
        lengths = a[0]["inp_len"]
        assert lengths.min() >= low and lengths.max() <= high
        # the same lengths for every seed, in another order
        assert sorted(lengths) == sorted(c[0]["inp_len"])
        valid = np.arange(width)[None, :] < lengths[:, None]
        assert not a[0]["feats"][~valid].any()
        assert (a[0]["labels"] < cfg["class_n"] - 1).all()
        assert a[0]["frames"] == lengths.sum()


def test_schedule_rotates_buckets_in_equal_shares():
    ctx = _ctx("srf_timit.train", 5)
    order = training.schedule(ctx.traffic, ctx.seed)
    count = len(ctx.traffic["buckets"])
    steps = [next(order) for _ in range(10 * count)]
    for i in range(0, len(steps), count):
        assert sorted(steps[i:i + count]) == list(range(count))
    again = training.schedule(ctx.traffic, ctx.seed)
    assert steps == [next(again) for _ in range(10 * count)]


def test_serve_plan_follows_seed_and_mix():
    ctx = _ctx("srf_wsj.serve", 2**31 + 99)
    traffic = ctx.traffic
    plan = serve_open.requests(traffic, 20.0, ctx.seed, 123)
    again = serve_open.requests(traffic, 20.0, ctx.seed, 123)
    other = serve_open.requests(traffic, 20.0, ctx.seed + 1, 123)
    assert len(plan) == round(traffic["rate"] * 20.0) == len(other)
    assert [t for t, _ in plan] == [t for t, _ in again]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(plan, again))
    low, high = traffic["frames"]
    lengths = [len(f) for _, f in plan]
    assert min(lengths) == low and max(lengths) == high
    assert sorted(lengths) == sorted(len(f) for _, f in other)
    times = np.array([t for t, _ in plan])
    assert (np.diff(times) > 0).all()
    # evenly spaced exponential quantiles: the mean gap is 1 / rate
    assert abs(np.diff(times).mean() * traffic["rate"] - 1) < 0.05
    widths = {-(-n // 128) * 128 for n in lengths}
    assert widths <= set(traffic["warm_widths"])


def test_serving_warms_and_serves_in_one_thread(tiny_root, monkeypatch):
    """cuDNN keeps its algorithm choices per thread: set-up warms the
    widths in the front end's worker, the thread that serves the window."""
    import threading

    from benchmark import run
    from benchmark.tests import tiny
    from srf_tpu_torch.serve import Recognizer

    threads = []
    inner = Recognizer.transcribe_batch_detailed

    def recorded(self, *args, **kwargs):
        threads.append(threading.get_ident())
        return inner(self, *args, **kwargs)

    monkeypatch.setattr(Recognizer, "transcribe_batch_detailed", recorded)
    line, checks = run.run(tiny.context(tiny_root, "srf_wsj.serve"))
    assert line["correct"], checks
    assert len(threads) > 1
    assert set(threads) == {threads[0]} != {threading.get_ident()}


def test_train_run_holds_the_mix_host_threads(tiny_root, monkeypatch):
    """A mix's ``host_threads`` holds every step's intra-op threads, and
    the run gives torch its own count back at its end."""
    import torch
    from benchmark import run
    from benchmark.tests import tiny

    ctx = tiny.context(tiny_root, "srf_timit.train", seconds=0.2)
    seen, take = [], training.take_step

    def counted(*args):
        seen.append(torch.get_num_threads())
        return take(*args)

    monkeypatch.setattr(training, "take_step", counted)
    before = torch.get_num_threads()
    line, _ = run.run(ctx)
    assert line["correct"]
    assert set(seen) == {ctx.traffic["host_threads"]} == {1}
    assert torch.get_num_threads() == before
