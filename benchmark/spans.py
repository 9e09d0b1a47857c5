"""The program's spans placed on a traced window's clock, and the
arithmetic of the per-layer metrics that read them (the benchmark's own
copy, so that a change to the program cannot move these yardsticks).

The port records spans and marks (``srf_tpu_torch/utils/profiler.py``) in
an in-process ring on the ``time.perf_counter_ns()`` clock. Those opened in
a thread whose profiler records appear in the window's host ranges
(``devtrace.Window.host``) on the profiler's clock too: every span of a
training window, and the serving sender's ``srf.serve.submit`` marks.
Matched by name and time, these anchors give the map between the two
clocks, which places every span of the ring, those of threads the
profiler does not see (the serving front end's worker) included. A
program without the ring (the port before it had one) or a window with no
anchor reads None.
"""

import bisect
import statistics

import numpy as np

PREFIX = "srf."
# an anchor matches the ring span of its name whose start lies closest to
# its range's once mapped, within this (us): a span or a mark reads the
# clock just inside its range
MATCH_US = 200.0
# anchors that score a candidate offset
SCORED = 32


def program_spans():
    """The program's ring as [(name, start_ns, end_ns, thread, parent,
    key)], or None where the program keeps none."""
    try:
        from srf_tpu_torch.utils.profiler import spans
    except ImportError:
        return None
    return [(s.name, s.start_ns, s.end_ns, s.thread, s.parent, s.key)
            for s in spans()]


def _starts_by_name(ring):
    """{name: (sorted starts (us), the entries in that order)}."""
    grouped = {}
    for entry in ring:
        grouped.setdefault(entry[0], []).append(entry)
    out = {}
    for name, entries in grouped.items():
        entries.sort(key=lambda e: e[1])
        out[name] = ([e[1] / 1e3 for e in entries], entries)
    return out


def _match(anchor, by_name, offset):
    """The ring entry that ``anchor`` (name, start_us, end_us) is, at
    ``offset`` (us added to a ring time), or None."""
    name, start = anchor[0], anchor[1] - offset
    if name not in by_name:
        return None
    starts, entries = by_name[name]
    i = bisect.bisect_left(starts, start)
    near = [j for j in (i - 1, i) if 0 <= j < len(starts)
            and abs(starts[j] - start) <= MATCH_US]
    if not near:
        return None
    return entries[min(near, key=lambda j: abs(starts[j] - start))]


def clock_map(window, ring):
    """A function from a ring time (ns) to the window's clock (us), or None
    where no anchor matches. The first anchor is paired with each ring
    span of its name in turn; the pairing under which most of the first
    ``SCORED`` anchors find their span wins, and a line through all the
    anchors it matches (least squares: the two clocks may run at slightly
    different rates) gives the map."""
    anchors = sorted(((name, start, end) for name, start, end in window.host
                      if name.startswith(PREFIX)), key=lambda a: a[1])
    if not anchors or not ring:
        return None
    by_name = _starts_by_name(ring)
    first = anchors[0]
    if first[0] not in by_name:
        return None
    best, best_score = None, 0
    for start in by_name[first[0]][0]:
        offset = first[1] - start
        score = sum(_match(a, by_name, offset) is not None
                    for a in anchors[:SCORED])
        if score > best_score:
            best, best_score = offset, score
    if best is None:
        return None
    pairs = np.array([(entry[1] / 1e3, anchor[1]) for anchor in anchors
                      for entry in [_match(anchor, by_name, best)]
                      if entry is not None])
    ring0, host0 = pairs.mean(axis=0)
    x, y = pairs[:, 0] - ring0, pairs[:, 1] - host0
    scale = float((x * y).sum() / (x * x).sum()) if (
        x.max() - x.min() >= 1e3) else 1.0
    return lambda t_ns: host0 + scale * (t_ns / 1e3 - ring0)


def place(window, ring):
    """The ring's spans on the window's clock, those that overlap the
    window: [(name, start_us, end_us, thread, parent, key)]; None where
    the ring cannot be placed."""
    to_window = clock_map(window, ring)
    if to_window is None:
        return None
    out = []
    for name, start, end, thread, parent, key in ring:
        start_us, end_us = to_window(start), to_window(end)
        if end_us >= window.start_us and start_us <= window.end_us:
            out.append((name, start_us, end_us, thread, parent, key))
    return out


def union(intervals):
    """The sorted union of [(start, end)]."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def overlap_us(first, second):
    """us in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(first) and j < len(second):
        start = max(first[i][0], second[j][0])
        end = min(first[i][1], second[j][1])
        if end > start:
            total += end - start
        if first[i][1] < second[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_s(window, placed, names):
    """Seconds of the window's device idle that lie inside spans named in
    ``names`` (children included: they lie inside their parent)."""
    inside = union((max(s, window.start_us), min(e, window.end_us))
                   for n, s, e, _, _, _ in placed if n in names)
    return overlap_us(window.gaps(), inside) / 1e6


def _placed(record):
    """(window, the program's spans placed on it), or None."""
    window = record.get("profile")
    if window is None or window.seconds <= 0:
        return None
    ring = program_spans()
    if not ring:
        return None
    placed = place(window, ring)
    if not placed:
        return None
    return window, placed


def idle_share_under(record, names):
    """Device idle under spans named in ``names`` over the window's
    length (%)."""
    found = _placed(record)
    if found is None:
        return None
    window, placed = found
    return 100.0 * idle_under_s(window, placed, names) / window.seconds


def feed_idle(record):
    """Device idle under the data feed's ``srf.feed`` spans (%)."""
    return idle_share_under(record, {"srf.feed"})


def step_idle(record):
    """Device idle under the train step's ``srf.step`` spans (%)."""
    return idle_share_under(record, {"srf.step"})


def recognizer_idle(record):
    """Device idle under the front end's ``srf.serve.batch`` spans (the
    Recognizer's call and the results) (%)."""
    return idle_share_under(record, {"srf.serve.batch"})


def queue_wait_ms(record):
    """The median, over the requests submitted in the window, of the time
    from a request's ``srf.serve.submit`` to its ``srf.serve.take`` (ms)."""
    found = _placed(record)
    if found is None:
        return None
    window, placed = found
    takes = {key: start for name, start, _, _, _, key in placed
             if name == "srf.serve.take"}
    waits = [takes[key] - start for name, start, _, _, _, key in placed
             if name == "srf.serve.submit" and key in takes
             and window.start_us <= start <= window.end_us]
    return statistics.median(waits) / 1e3 if waits else None


def hold_ms(record):
    """The mean length of the ``srf.serve.hold`` spans (a batch's, from its
    first take until it closes) that began in the window (ms)."""
    found = _placed(record)
    if found is None:
        return None
    window, placed = found
    holds = [end - start for name, start, end, _, _, _ in placed
             if name == "srf.serve.hold"
             and window.start_us <= start <= window.end_us]
    return sum(holds) / len(holds) / 1e3 if holds else None


def idle_by_name(window, placed):
    """{span name: seconds of device idle inside its spans}, and the
    seconds of idle inside any span of the names that have no parent on
    their thread in ``placed`` (each thread's outermost spans)."""
    names = {n for n, _, _, _, _, _ in placed}
    by_name = {n: idle_under_s(window, placed, {n}) for n in sorted(names)}
    outer = {n for n, _, _, _, parent, _ in placed if parent is None}
    return by_name, idle_under_s(window, placed, outer)
