"""Which device operations of a profiled window the maxout CNN's
convolutions launched and which are K5's, and the bounds of the calls
that ran there.

A convolution runs whatever kernels cuDNN's chosen algorithm launches
(implicit GEMMs, FFTs, layout transposes, reductions), so they are not
found by name but by launch. ``devtrace.Window`` keeps the host's ranges,
among them each call that queues device work (a kernel launch:
``cudaLaunchKernel``, ``cuLaunchKernel`` and their ``Ex`` forms; a copy;
a memset), and the device's operations. A train step runs on one stream, so
the device runs its operations in the order the host queued them: the
i-th launch call is the i-th kernel. A kernel is a convolution's where
its launch call lies inside a convolution's host range (the operator
``aten::convolution`` or ``aten::convolution_backward``, or the program's
own ``srf.conv.*`` spans).

The profiler loses a device record now and then (about one in 8,000
kernels on an H100, torch 2.11). The copies and memsets split both
sequences into runs of kernels between them; a run whose launch calls
and kernels are not as many lost a record, and its kernels are left out
(a fraction of a step's). Where the copies and memsets themselves do not
pair, nothing is read.

K5 is one hand-written kernel, ``fused_dropout_kernel``, found by name.
"""

import bisect

from benchmark.counts import cnn_flops
from benchmark.reference import cnn as reference

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
# host calls that queue a device record other than a kernel, by the
# record's kind
QUEUES = {"cudaMemcpyAsync": "Memcpy", "cudaMemcpy": "Memcpy",
          "cudaMemsetAsync": "Memset", "cudaMemset": "Memset"}
CONV_RANGES = ("aten::convolution", "aten::convolution_backward")
CONV_SPAN = "srf.conv."
K5 = "fused_dropout_kernel"


def _is_conv_range(name):
    return name in CONV_RANGES or name.startswith(CONV_SPAN)


def _runs(items, kind_of):
    """``items`` split at their copies and memsets: [(the kind that ends
    the run or None, [the run's kernels])]."""
    runs, current = [], []
    for item in items:
        kind = kind_of(item)
        if kind is None:
            current.append(item)
        else:
            runs.append((kind, current))
            current = []
    runs.append((None, current))
    return runs


def conv_device_s(window):
    """Device seconds of the kernels the window's convolutions launched,
    or None where the window's launches and device records cannot be
    paired."""
    calls = sorted((start, name) for name, start, _ in window.host
                   if name in LAUNCHES or name in QUEUES)
    host = _runs(calls, lambda call: QUEUES.get(call[1]))
    device = _runs(window.kernels, lambda k: next(
        (kind for kind in ("Memcpy", "Memset") if k[0].startswith(kind)),
        None))
    if [kind for kind, _ in host] != [kind for kind, _ in device]:
        return None
    ranges = []  # the union of the convolutions' ranges
    for start, end in sorted((start, end) for name, start, end
                             in window.host if _is_conv_range(name)):
        if ranges and start <= ranges[-1][1]:
            ranges[-1][1] = max(ranges[-1][1], end)
        else:
            ranges.append([start, end])
    starts = [start for start, _ in ranges]
    total, paired = 0.0, 0
    for (_, launched), (_, kernels) in zip(host, device):
        if len(launched) != len(kernels):
            continue
        paired += len(kernels)
        for (at, _), (_, start, end) in zip(launched, kernels):
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and ranges[i][1] >= at:
                total += (end - start) / 1e6
    return total if paired else None


def k5_device_s(window):
    """Device seconds of K5's launches in the window."""
    return window.device_ms(K5) / 1e3


def conv_bound_s(cfg, batch, frames):
    """Least seconds of one train step's convolutions on a padded [batch,
    frames] input."""
    return sum(cnn_flops.bound_s(nbytes, ops) for _, nbytes, ops
               in reference.conv_calls(batch, frames, cfg))


def k5_bound_s(cfg, batch, frames):
    """Least seconds of one train step's K5 launches: each dropout site
    whose rate is above zero reads and writes its elements once in the
    forward, and its cotangent's once in the backward."""
    nbytes = sum(2 * 8 * n for n, rate in
                 reference.dropout_sites(batch, frames, cfg) if rate > 0)
    return cnn_flops.bound_s(nbytes, 0.0)
