"""Profiling / tracing hooks (port of ``srf_tpu/utils/profiler.py`` over
``torch.profiler``).

- :func:`trace`: context manager around ``torch.profiler.profile`` (the
  host and, where there is one, the CUDA device), writing a Chrome trace of
  the traced region under ``log_dir`` (``chrome://tracing``, Perfetto).
  On the card torch.profiler drops device records, most often the first
  ones of a trace (torch 2.11 + CUDA 12.8 on an H100; the cause is not
  known): the trace starts with PRIMING_KERNELS one-cycle sleep kernels
  inside a ``PRIMING_RANGE`` range, which take the loss, and the written
  file leaves out every event that began before that range ended,
- :class:`StepTimer`: host-side per-step wall timing with summary stats,
  waiting for the result's CUDA device where JAX calls
  ``block_until_ready``,
- :func:`annotate`: a named ``record_function`` range for attribution.
"""

import contextlib
import json
import os
import time

import numpy as np
import torch


PRIMING_RANGE = "srf_profiler_priming"
PRIMING_KERNELS = 64


def _prime_device():
    """The priming's device work: PRIMING_KERNELS one-cycle sleep kernels
    and a synchronize, where there is a CUDA device."""
    if torch.cuda.is_available():
        for _ in range(PRIMING_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def strip_priming(path):
    """Rewrite the Chrome trace at ``path`` without its priming: every
    timed event ("ph" other than "M", the metadata) that began before the
    ``PRIMING_RANGE`` range ended, the range included. The priming ends in
    a synchronize inside that range, so its device records all begin
    before the range ends. Returns how many events went."""
    with open(path) as src:
        doc = json.load(src)
    events = doc["traceEvents"]
    ends = [e["ts"] + e.get("dur", 0) for e in events
            if e.get("name") == PRIMING_RANGE]
    if not ends:
        return 0
    end = max(ends)
    kept = [e for e in events if e.get("ph") == "M" or "ts" not in e
            or e["ts"] >= end]
    doc["traceEvents"] = kept
    with open(path, "w") as dst:
        json.dump(doc, dst)
    return len(events) - len(kept)


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Profile the enclosed region and write its Chrome trace under
    ``log_dir`` (one file per process and start time); yields the path
    the trace is written to. The trace is primed before the region and
    written without the priming (module docstring)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(log_dir), "trace_%d_%d.json" % (
        os.getpid(), time.time_ns()))
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(PRIMING_RANGE):
            _prime_device()
        yield path
    prof.export_chrome_trace(path)
    strip_priming(path)


def annotate(name):
    return torch.profiler.record_function(name)


def _synchronize(result):
    """Wait for every CUDA device holding a tensor of ``result``."""
    devices = set()

    def visit(value):
        if torch.is_tensor(value):
            if value.is_cuda:
                devices.add(value.device)
        elif isinstance(value, dict):
            for item in value.values():
                visit(item)
        elif isinstance(value, (list, tuple)):
            for item in value:
                visit(item)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock timing of steps (waits for the result's device)."""

    def __init__(self, warmup=2):
        self.warmup = warmup
        self.times = []
        self._count = 0

    @contextlib.contextmanager
    def step(self, result_to_block=None):
        start = time.perf_counter()
        yield
        if result_to_block is not None:
            _synchronize(result_to_block)
        elapsed = time.perf_counter() - start
        self._count += 1
        if self._count > self.warmup:
            self.times.append(elapsed)

    def summary(self):
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "min_ms": float(arr.min() * 1e3),
        }
