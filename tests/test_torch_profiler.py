"""The port's tracing (``utils/profiler.py``) on the CPU: the span ring
(name, parent, thread, key; bounded; a ``record_function`` only where the
calling thread's profiler records; a thread that ran before the profiler
reaches the ring alone), and ``trace``, which writes a Chrome trace that
holds the spans, the priming left out, and every thread where the torch
build records them."""

import json
import threading
import time

import pytest
import torch

from srf_tpu_torch.utils import profiler

torch.set_num_threads(1)


def test_trace_writes_the_annotated_ranges(tmp_path):
    with profiler.trace(str(tmp_path / "prof")) as path:
        with profiler.span("srf_test_range"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert path.startswith(str(tmp_path / "prof"))
    with open(path) as trace:
        events = json.load(trace)["traceEvents"]
    assert any(e.get("name") == "srf_test_range" for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    with profiler.trace(str(tmp_path / "prof"), enabled=False) as path:
        torch.ones(2) + 1
    assert path is None and not (tmp_path / "prof").exists()


def test_trace_primes_and_writes_no_priming(tmp_path, monkeypatch):
    """``trace`` primes before the region (on the card: sleep kernels that
    take the profiler's lost records) and writes the trace without the
    priming: here the priming's stand-in runs CPU work in a range of its
    own, which the written file does not hold, while it holds the
    region's."""
    order = []

    def prime():
        order.append("primed")
        with profiler.span("srf_priming_probe"):
            torch.ones(8, 8) @ torch.ones(8, 8)

    monkeypatch.setattr(profiler, "_prime_device", prime)
    with profiler.trace(str(tmp_path / "prof")) as path:
        order.append("region")
        with profiler.span("srf_test_range"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert order == ["primed", "region"]
    with open(path) as trace:
        names = {e.get("name") for e in json.load(trace)["traceEvents"]}
    assert "srf_test_range" in names
    assert not names & {"srf_priming_probe", profiler.PRIMING_RANGE}


def test_strip_priming_drops_what_began_before_the_priming_ended(tmp_path):
    path = tmp_path / "trace.json"
    events = [{"ph": "M", "name": "process_name", "pid": 1},
              {"ph": "X", "name": profiler.PRIMING_RANGE, "ts": 10, "dur": 5},
              {"ph": "X", "name": "spin_kernel", "ts": 12, "dur": 1,
               "cat": "kernel"},
              {"ph": "X", "name": "region", "ts": 15, "dur": 4},
              {"ph": "X", "name": "kernel", "ts": 16, "dur": 2,
               "cat": "kernel"}]
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiler.strip_priming(str(path)) == 2
    kept = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in kept] == ["process_name", "region", "kernel"]
    # a trace without the range is left as it was
    assert profiler.strip_priming(str(path)) == 0


def _ours(name):
    """The ring's entries named ``name``."""
    return [s for s in profiler.spans() if s.name == name]


def test_the_ring_records_name_parent_thread_and_key():
    before = time.perf_counter_ns()
    with profiler.span("srf_test.outer", key=7):
        with profiler.span("srf_test.inner"):
            profiler.mark("srf_test.mark", key=8)
    after = time.perf_counter_ns()
    outer, = _ours("srf_test.outer")
    inner, = _ours("srf_test.inner")
    instant, = _ours("srf_test.mark")
    me = threading.get_ident()
    assert (outer.parent, outer.key, outer.thread) == (None, 7, me)
    assert (inner.parent, inner.key, inner.thread) == (
        "srf_test.outer", None, me)
    assert (instant.parent, instant.key) == ("srf_test.inner", 8)
    assert instant.start_ns == instant.end_ns
    assert (before <= outer.start_ns <= inner.start_ns <= instant.start_ns
            <= inner.end_ns <= outer.end_ns <= after)
    # an exception leaves the stack as it was: the next span has no parent
    with pytest.raises(ValueError):
        with profiler.span("srf_test.raised"):
            raise ValueError
    with profiler.span("srf_test.after"):
        pass
    assert _ours("srf_test.raised")[0].parent is None
    assert _ours("srf_test.after")[0].parent is None


def test_the_ring_is_bounded():
    for i in range(profiler.RING_SIZE + 10):
        profiler.mark("srf_test.bounded", key=i)
    ring = profiler.spans()
    assert len(ring) == profiler.RING_SIZE
    # the oldest went first
    assert [s.key for s in ring[-3:]] == [profiler.RING_SIZE + k
                                         for k in (7, 8, 9)]
    assert ring[0].key == 10


def test_a_span_opens_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiler.span("srf_test.quiet"):
        profiler.mark("srf_test.quiet_mark")
    assert opened == []
    assert _ours("srf_test.quiet") and _ours("srf_test.quiet_mark")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("srf_test.loud"):
            profiler.mark("srf_test.loud_mark")
    assert opened == ["srf_test.loud", "srf_test.loud_mark"]


def test_a_span_under_a_profiler_is_in_its_events():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("srf_test.recorded", key=3):
            torch.ones(4, 4) @ torch.ones(4, 4)
        profiler.mark("srf_test.recorded_mark")
    events = {e.name: e for e in prof.events()}
    assert {"srf_test.recorded", "srf_test.recorded_mark"} <= set(events)
    ring, = _ours("srf_test.recorded")
    # the range encloses the ring's interval: the same length within the
    # span's own cost
    rng = events["srf_test.recorded"].time_range
    assert 0 <= (rng.end - rng.start) - (ring.end_ns - ring.start_ns) / 1e3
    assert (rng.end - rng.start) - (ring.end_ns - ring.start_ns) / 1e3 < 5e3


def _worker(name, go, done):
    """A thread started before a profiler: waits for ``go``, then opens a
    span ``name`` around a matrix product."""

    def run():
        assert go.wait(timeout=30)
        with profiler.span(name):
            torch.ones(8, 8) @ torch.ones(8, 8)
        done.set()

    thread = threading.Thread(target=run)
    thread.start()
    return thread


def test_a_thread_older_than_the_profiler_reaches_the_ring():
    go, done = threading.Event(), threading.Event()
    thread = _worker("srf_test.older_thread", go, done)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        go.set()
        assert done.wait(timeout=30)
    thread.join(timeout=30)
    assert not thread.is_alive()
    entry, = _ours("srf_test.older_thread")
    assert entry.thread == thread.ident
    # the profiler of another thread did not record it
    assert "srf_test.older_thread" not in {e.name for e in prof.events()}


def test_trace_records_every_thread_where_torch_can(tmp_path):
    go, done = threading.Event(), threading.Event()
    thread = _worker("srf_test.traced_thread", go, done)
    with profiler.trace(str(tmp_path / "prof")) as path:
        go.set()
        assert done.wait(timeout=30)
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert _ours("srf_test.traced_thread")
    with open(path) as trace:
        names = {e.get("name") for e in json.load(trace)["traceEvents"]}
    assert ("srf_test.traced_thread" in names) == (
        profiler.all_threads_config() is not None)
    # spans after the trace ask the thread's own profiler again
    assert not profiler._all_threads
