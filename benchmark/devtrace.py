"""A primed ``torch.profiler`` window, reduced in memory to what the
per-layer metrics and the breakdown read; no trace file is written.

On the card the profiler drops device records, most often a trace's first
ones (seen with the port on an H100: PERF.md). Each window therefore starts
with ``PRIMING`` one-cycle sleep kernels and a synchronize inside a
``bench.priming`` range, which take the loss; only device records that
begin inside the ``bench.window`` range that follows are kept.
"""

import contextlib

PRIMING = 64
WINDOW_RANGE = "bench.window"
PRIMING_RANGE = "bench.priming"


class Window:
    """What a profiled window leaves: ``kernels`` [(name, start_us,
    end_us)] of the device (kernels, copies and sets), sorted by start;
    ``host`` [(name, start_us, end_us)] of the host's ranges and operators;
    ``start_us``, ``end_us`` of the window on the profiler's clock; and
    ``info``, what the profiled function returned."""

    def __init__(self):
        self.kernels, self.host, self.info = [], [], None
        self.start_us = self.end_us = 0.0

    @property
    def seconds(self):
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self):
        """Seconds in which some device operation ran (their union)."""
        busy, last = 0.0, self.start_us
        for _, start, end in self.kernels:
            start, end = max(start, last), min(end, self.end_us)
            if end > start:
                busy += end - start
                last = end
        return busy / 1e6

    def gaps(self):
        """[(start_us, end_us)] of the device's idle stretches."""
        out, last = [], self.start_us
        for _, start, end in self.kernels:
            if start > last:
                out.append((last, start))
            last = max(last, end)
        if self.end_us > last:
            out.append((last, self.end_us))
        return out

    def device_ms(self, *symbols):
        """ms of the device operations whose name holds any of
        ``symbols``."""
        return sum(end - start for name, start, end in self.kernels
                   if any(s in name for s in symbols)) / 1e3

    def breakdown(self, count=10):
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host range or operator running
        at its middle: {"device_ops": [[name, s]], "idle_gaps": [[name,
        s]]}."""
        by_name = {}
        for name, start, end in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:count]
        named = []
        for start, end in gaps:
            middle, inner = (start + end) / 2, None
            for name, h_start, h_end in self.host:
                if h_start <= middle <= h_end and (
                        inner is None or h_start >= inner[1]):
                    inner = (name, h_start)
            named.append([inner[0] if inner else
                          "no host operator (a queue's wait, Python)",
                          (end - start) / 1e6])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in named]}


def _annotation(evt):
    """True for a host range's shadow on the device's timeline (the
    profiler draws each ``record_function`` range there too): not an
    operation the device ran."""
    if getattr(evt, "is_user_annotation", False):
        return True
    kind = str(getattr(evt, "activity_type", "") or "").lower()
    return "annotation" in kind or evt.name.startswith("bench.")


@contextlib.contextmanager
def annotate(torch, name):
    """A named host range the breakdown can name idle gaps by."""
    with torch.profiler.record_function(name):
        yield


def profiled(torch, fn, device_sync=True):
    """Run ``fn()`` inside a primed profiler window; returns a
    :class:`Window`. The window's range ends after a synchronize, so it
    holds every device operation ``fn`` queued."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device_sync:
        activities.append(ProfilerActivity.CUDA)
    out = Window()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(PRIMING_RANGE):
            if device_sync:
                for _ in range(PRIMING):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW_RANGE):
            out.info = fn()
            if device_sync:
                torch.cuda.synchronize()
    events = prof.events()
    device_type = torch.autograd.DeviceType
    window = [e for e in events if e.name == WINDOW_RANGE]
    if not window:
        raise RuntimeError("the profiler kept no window range")
    out.start_us = window[0].time_range.start
    out.end_us = window[0].time_range.end
    for evt in events:
        span = (evt.name, evt.time_range.start, evt.time_range.end)
        if evt.device_type == device_type.CUDA:
            if span[1] >= out.start_us and not _annotation(evt):
                out.kernels.append(span)
        elif span[1] >= out.start_us and evt.name != WINDOW_RANGE:
            out.host.append(span)
    out.kernels.sort(key=lambda k: k[1])
    return out
