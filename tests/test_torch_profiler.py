"""The port's profiling hooks (``utils/profiler.py``) on the CPU: ``trace``
writes a Chrome trace that holds the ranges ``annotate`` names, and
``StepTimer`` gives the same summary as ``srf_tpu.utils.profiler``'s on
the same clock readings (exact: both read one patched clock)."""

import itertools
import json
import time

import pytest
import torch

from srf_tpu.utils import profiler as jax_profiler
from srf_tpu_torch.utils import profiler

torch.set_num_threads(1)


def test_trace_writes_the_annotated_ranges(tmp_path):
    with profiler.trace(str(tmp_path / "prof")) as path:
        with profiler.annotate("srf_test_range"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert path.startswith(str(tmp_path / "prof"))
    with open(path) as trace:
        events = json.load(trace)["traceEvents"]
    assert any(e.get("name") == "srf_test_range" for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    with profiler.trace(str(tmp_path / "prof"), enabled=False) as path:
        torch.ones(2) + 1
    assert path is None and not (tmp_path / "prof").exists()


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_summary_equals_jax(monkeypatch, warmup):
    # step i takes (i + 1) ms on the patched clock
    durations = [1e-3 * (i + 1) for i in range(6)]
    timers = {"torch": profiler.StepTimer(warmup), "jax":
              jax_profiler.StepTimer(warmup)}
    summaries = {}
    for name, timer in timers.items():
        readings = itertools.chain.from_iterable(
            (10.0 * i, 10.0 * i + d) for i, d in enumerate(durations))
        monkeypatch.setattr(time, "perf_counter", lambda: next(readings))
        for _ in durations:
            if name == "torch":
                out = []  # the step's result, filled inside the block
                with timer.step(out):
                    out.append({"loss": torch.ones(2)})
            else:
                with timer.step():
                    pass
        summaries[name] = timer.summary()
    assert summaries["torch"] == summaries["jax"]
    assert summaries["torch"]["steps"] == len(durations) - warmup
    assert summaries["torch"]["min_ms"] == pytest.approx(1.0 * (warmup + 1))


def test_step_timer_without_steps_is_empty():
    assert profiler.StepTimer().summary() == {}


def test_trace_primes_and_writes_no_priming(tmp_path, monkeypatch):
    """``trace`` primes before the region (on the card: sleep kernels that
    take the profiler's lost records) and writes the trace without the
    priming: here the priming's stand-in runs CPU work in a range of its
    own, which the written file does not hold, while it holds the
    region's."""
    order = []

    def prime():
        order.append("primed")
        with profiler.annotate("srf_priming_probe"):
            torch.ones(8, 8) @ torch.ones(8, 8)

    monkeypatch.setattr(profiler, "_prime_device", prime)
    with profiler.trace(str(tmp_path / "prof")) as path:
        order.append("region")
        with profiler.annotate("srf_test_range"):
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
