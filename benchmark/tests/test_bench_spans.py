"""``benchmark/spans.py`` on the CPU: the program's spans placed on a
profiled window's clock (those of the profiler's thread on their own
ranges; a worker's, which the profiler does not see, by the sender's
``srf.serve.submit`` anchors), the seven readers over synthetic windows
and rings, None where the program keeps no ring or the window no anchor,
and each traced tiny cell's line holding its readers' metrics."""

import os
import statistics
import threading
import time

import pytest
import torch

from benchmark import devtrace, run, spans
from benchmark.devtrace import Window
from benchmark.tests import tiny
from srf_tpu_torch.utils import profiler

READERS = {"srf_wsj.train": ("feed_idle.train", "step_idle.train"),
           "srf_timit.train": ("feed_idle.train_timit",
                               "step_idle.train_timit"),
           "srf_wsj.serve": ("queue_wait_ms.serve", "hold_ms.serve",
                             "recognizer_idle.serve")}


def _reader(name):
    import importlib.util

    path = os.path.join(os.path.dirname(spans.__file__), "metrics",
                        name + ".py")
    loader = importlib.util.spec_from_file_location("reader", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def _busy(n=8):
    x = torch.randn(32, 32)
    for _ in range(n):
        x = torch.tanh(x @ x)
    return x


def test_spans_of_the_profilers_thread_land_on_their_ranges():
    def traced():
        for i in range(40):
            with profiler.span("srf.test_outer", key=i):
                _busy()
                with profiler.span("srf.test_inner"):
                    _busy()
            profiler.mark("srf.test_mark", key=i)
            _busy()

    window = devtrace.profiled(torch, traced, device_sync=False)
    ring = spans.program_spans()
    to_window = spans.clock_map(window, ring)
    ranges = {}
    for name, start, end in window.host:
        ranges.setdefault(name, []).append((start, end))
    for name in ("srf.test_outer", "srf.test_inner", "srf.test_mark"):
        mine = sorted(e for e in ring if e[0] == name)[-40:]
        theirs = sorted(ranges[name])
        assert len(theirs) == 40
        starts, ends = [], []
        for entry, (start, end) in zip(mine, theirs):
            # a span reads the clock inside its range, so it lands inside
            # (a thread descheduled there only moves it further in)
            assert start - 200.0 < to_window(entry[1])
            assert to_window(entry[2]) < end + 200.0
            starts.append(abs(to_window(entry[1]) - start))
            ends.append(abs(to_window(entry[2]) - end))
        assert statistics.median(starts) < 200.0
        assert statistics.median(ends) < 200.0


def test_a_workers_spans_are_placed_by_the_submit_anchors():
    """A thread that ran before the profiler: its spans are not among the
    window's ranges, and are placed by the sender's marks."""
    jobs, done = [], []
    go = threading.Event()

    def worker():
        while True:
            assert go.wait(timeout=30)
            if not jobs:
                return
            key = jobs.pop(0)
            profiler.mark("srf.serve.take", key)
            with profiler.span("srf.test_work", key):
                _busy()
            done.append(key)
            go.clear()

    thread = threading.Thread(target=worker)
    thread.start()
    keys = range(10 ** 9, 10 ** 9 + 20)

    def traced():
        _busy()  # the first submit well inside the window
        for key in keys:
            profiler.mark("srf.serve.submit", key)
            jobs.append(key)
            go.set()
            deadline = time.monotonic() + 30
            while key not in done and time.monotonic() < deadline:
                time.sleep(1e-4)
        return None

    try:
        window = devtrace.profiled(torch, traced, device_sync=False)
    finally:
        go.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert not any(name == "srf.test_work" for name, _, _ in window.host)
    placed = spans.place(window, spans.program_spans())
    submit = {k: s for n, s, _, _, _, k in placed if n == "srf.serve.submit"}
    take = {k: s for n, s, _, _, _, k in placed if n == "srf.serve.take"}
    work = {k: (s, e) for n, s, e, _, _, k in placed if n == "srf.test_work"}
    assert set(submit) == set(take) == set(work) == set(keys)
    anchors = sorted((s, e) for n, s, e in window.host
                     if n == "srf.serve.submit")
    for key in keys:
        start, end = anchors[key - keys[0]]
        assert start - 200.0 < submit[key] < end + 200.0
        assert submit[key] <= take[key] <= work[key][0] <= work[key][1]
        assert work[key][1] <= window.end_us


def _window(kernels, host, start=0.0):
    """A 10 ms window from ``start`` (us) whose device ran ``kernels``
    [(start, end)] (us from the window's start)."""
    window = Window()
    window.start_us, window.end_us = start, start + 10000.0
    window.kernels = [("k", start + s, start + e) for s, e in kernels]
    window.host = host
    return window


OFFSET_US = 5.0e6  # the window's clock runs this far ahead of the ring's


def _ring(entries):
    """Ring entries from (name, start_us, end_us on the window's clock,
    thread, parent, key)."""
    return [(n, int((s - OFFSET_US) * 1e3), int((e - OFFSET_US) * 1e3), t,
             p, k) for n, s, e, t, p, k in entries]


TRAIN = [("srf.feed", 500, 1500, 1, None, None),
         ("srf.feed.load", 500, 1400, 1, "srf.feed", None),
         ("srf.step", 1500, 3500, 1, None, None),
         ("srf.feed", 6000, 6500, 1, None, None),
         ("srf.step", 6500, 9500, 1, None, None)]
# busy 0-1000, 3000-6000, 8000-9000: idle 1000-3000, 6000-8000, 9000-10000
KERNELS = [(0, 1000), (3000, 6000), (8000, 9000)]


@pytest.mark.parametrize("cell", ["srf_wsj.train", "srf_timit.train"])
def test_the_training_readers(monkeypatch, cell):
    ring = _ring(TRAIN)
    monkeypatch.setattr(spans, "program_spans", lambda: ring)
    window = _window(KERNELS, [(n, s + OFFSET_US, e + OFFSET_US)
                               for n, s, e, _, _, _ in TRAIN], OFFSET_US)
    record = {"profile": window}
    feed, step = READERS[cell]
    # idle under the feed: 1000-1500 and 6000-6500 of the 10 ms window
    assert _reader(feed)(record) == pytest.approx(10.0)
    # under the step: 1500-3000, 6500-8000, 9000-9500
    assert _reader(step)(record) == pytest.approx(35.0)


SERVE = [("srf.serve.submit", 100, 100, 1, None, 1),
         ("srf.serve.submit", 2000, 2000, 1, None, 2),
         ("srf.serve.submit", 2100, 2100, 1, None, 3),
         ("srf.serve.wait", 0, 150, 2, None, None),
         ("srf.serve.hold", 150, 1150, 2, None, 7),
         ("srf.serve.take", 150, 150, 2, "srf.serve.hold", 1),
         ("srf.serve.batch", 1150, 1900, 2, None, 7),
         ("srf.serve.forward", 1200, 1800, 2, "srf.serve.batch", None),
         ("srf.serve.wait", 1900, 2500, 2, None, None),
         ("srf.serve.hold", 2500, 3500, 2, None, 8),
         ("srf.serve.take", 2500, 2500, 2, "srf.serve.hold", 2),
         ("srf.serve.take", 2600, 2600, 2, "srf.serve.hold", 3),
         ("srf.serve.batch", 3500, 9000, 2, None, 8),
         # before the window: neither counted nor an anchor
         ("srf.serve.submit", -900, -900, 1, None, 0),
         ("srf.serve.take", -100, -100, 2, "srf.serve.hold", 0)]


def test_the_serving_readers(monkeypatch):
    ring = _ring(SERVE)
    monkeypatch.setattr(spans, "program_spans", lambda: ring)
    anchors = [(n, s + OFFSET_US, e + OFFSET_US)
               for n, s, e, _, _, _ in SERVE[:3]]
    window = _window(KERNELS, anchors, OFFSET_US)
    record = {"profile": window}
    # submit to take: 50, 500 and 500 us
    assert _reader("queue_wait_ms.serve")(record) == pytest.approx(0.5)
    # holds of 1000 us each
    assert _reader("hold_ms.serve")(record) == pytest.approx(1.0)
    # idle under the batches: 1150-1900 and 6000-8000 (9000-10000 is after
    # the second batch)
    assert _reader("recognizer_idle.serve")(record) == pytest.approx(27.5)
    placed = spans.place(window, ring)
    by_name, outer = spans.idle_by_name(window, placed)
    assert by_name["srf.serve.forward"] == pytest.approx(600e-6)
    # wait, hold and batch cover 0-9000 of the idle: all but 9000-10000
    assert outer == pytest.approx(4000e-6)


def test_the_readers_read_none_without_a_ring_or_anchors(monkeypatch):
    window = _window(KERNELS, [(n, s, e) for n, s, e, _, _, _ in TRAIN])
    names = [name for cell in READERS.values() for name in cell]
    # the program before it kept a ring
    monkeypatch.delattr(profiler, "spans")
    assert spans.program_spans() is None
    for name in names:
        assert _reader(name)({"profile": window}) is None
    monkeypatch.undo()
    # a window none of whose ranges is a program span, or no window
    monkeypatch.setattr(spans, "program_spans", lambda: _ring(TRAIN))
    bare = _window(KERNELS, [("aten::mm", 100, 200)])
    for name in names:
        assert _reader(name)({"profile": bare}) is None
        assert _reader(name)({"profile": None}) is None


@pytest.mark.parametrize("cell", sorted(READERS))
def test_a_traced_tiny_cell_reports_its_span_metrics(tiny_root, cell):
    line, _ = run.run(tiny.context(tiny_root, cell, trace=True))
    assert line["correct"]
    for name in READERS[cell]:
        assert line["metrics"][name]["value"] >= 0.0
