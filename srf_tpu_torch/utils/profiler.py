"""Tracing of the port (port of ``srf_tpu/utils/profiler.py`` over
``torch.profiler``).

- :class:`span` and :func:`mark`: a named interval and a named instant at a
  layer boundary. Each goes into one bounded in-process ring
  (``RING_SIZE`` entries, the oldest dropped first) on the
  ``time.perf_counter_ns()`` clock, with its thread, the span around it on
  that thread (its parent) and a ``key`` (a request or batch id, shared by
  the spans of one request). The ring stays on: a span costs about 2 us
  of host time (an H100 machine's host, torch 2.11). Where the calling
  thread has a torch profiler recording, the span also opens a
  ``record_function`` of the same name, which puts it in the profiler's
  trace on the profiler's own clock; a ``record_function`` costs 12-15
  us, so no span opens one otherwise. A profiler started in one thread
  does not record a thread that already ran (a server's worker; torch
  2.11 and 2.13): such spans reach the ring only. :func:`spans` returns
  the ring.
- :func:`trace`: context manager around ``torch.profiler.profile`` (the
  host of every thread where the torch build can record them, and where
  there is one, the CUDA device), writing a Chrome trace of the traced
  region under ``log_dir`` (``chrome://tracing``, Perfetto). On the card
  torch.profiler drops device records, most often the first ones of a
  trace (torch 2.11 + CUDA 12.8 on an H100; the cause is not known): the
  trace starts with PRIMING_KERNELS one-cycle sleep kernels inside a
  ``PRIMING_RANGE`` range, which take the loss, and the written file
  leaves out every event that began before that range ended.

The spans' names are fixed where they are opened: ``srf.feed`` (and
``srf.feed.load``, ``srf.feed.put``) in ``train/loop.py``, ``srf.step``
(``.forward``, ``.loss``, ``.backward``, ``.optimizer``) in
``train/step.py``, ``srf.serve.*`` in ``serve_daemon.py`` and ``serve.py``,
``srf.conv.choose`` (a convolution problem's first call, keyed by the
problem) in ``ops/conv_choice.py``, ``srf.cnn.body`` and ``srf.cnn.proj``
in ``models/cnn.py``.
"""

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, NamedTuple, Optional

import torch


PRIMING_RANGE = "srf_profiler_priming"
PRIMING_KERNELS = 64
# a 3 s window of any benchmark cell holds under 10^4 spans
RING_SIZE = 1 << 16


class Span(NamedTuple):
    """One entry of the ring; a mark has ``start_ns == end_ns``."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    key: Any


# The ring holds plain tuples of atomic values, which the garbage
# collector stops tracking, so a full ring adds nothing to its scans.
_ring = collections.deque(maxlen=RING_SIZE)
_local = threading.local()
_profiler_enabled = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns
_thread = threading.get_ident
# True while ``trace`` records every thread: a thread's own profiler flag
# then stays False, so spans ask this one too
_all_threads = False


def _stack():
    """The calling thread's open spans' names, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """``with span(name, key=None) as s:`` records the enclosed interval in
    the ring, and in a recording profiler's trace (module docstring);
    ``s.start_ns`` and ``s.end_ns`` hold it after the block."""

    __slots__ = ("name", "key", "start_ns", "end_ns", "_stack", "_range")

    def __init__(self, name, key=None):
        self.name, self.key = name, key

    def __enter__(self):
        self._stack = stack = _stack()
        stack.append(self.name)
        self._range = None
        if _all_threads or _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = _now()
        return self

    def __exit__(self, *exc):
        self.end_ns = _now()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = self._stack
        stack.pop()
        _ring.append((self.name, self.start_ns, self.end_ns, _thread(),
                      stack[-1] if stack else None, self.key))
        return False


def mark(name, key=None):
    """Records an instant in the ring, and in a recording profiler's trace
    (as an empty range around it); returns its time (ns)."""
    if _all_threads or _profiler_enabled():
        with torch.profiler.record_function(name):
            now = _now()
    else:
        now = _now()
    stack = _stack()
    _ring.append((name, now, now, _thread(), stack[-1] if stack else None,
                  key))
    return now


def spans():
    """The ring's entries as :class:`Span`, oldest first."""
    return [Span(*entry) for entry in _ring.copy()]


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
    global _all_threads
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(log_dir), "trace_%d_%d.json" % (
        os.getpid(), time.time_ns()))
    config = all_threads_config()
    options = {} if config is None else {"experimental_config": config}
    with torch.profiler.profile(activities=activities, **options) as prof:
        with torch.profiler.record_function(PRIMING_RANGE):
            _prime_device()
        _all_threads = config is not None
        try:
            yield path
        finally:
            _all_threads = False
    prof.export_chrome_trace(path)
    strip_priming(path)


def all_threads_config():
    """The profiler's configuration that records every thread of the
    process, or None where this torch build has no such option."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None
