"""Which device operations of a profiled window are K1's and which K2's,
and the bounds of the calls that ran there.

K1 (``csrc/sdr_fwd.cu``) launches the prediction kernel
(``sdr_predict_kernel``, shared with K2) and its recurrence; K2
(``csrc/sdr_bwd.cu``) the prediction kernel, the reverse-time kernel, the
weight gradient and its reduction. A prediction launch belongs to the
routing kernel that follows it on the device.
"""

import math

from benchmark.counts import sdr_bounds
from benchmark.reference import srf as reference

PREDICT = "sdr_predict_kernel"
K1_OWN = ("sdr_fwd_kernel",)
K2_OWN = ("sdr_bwd_step_kernel", "sdr_bwd_wgrad_kernel",
          "sdr_bwd_reduce_kernel")


def device_s(window):
    """(K1 seconds, K2 seconds) of the window's device operations."""
    k1 = k2 = pending = 0.0
    for name, start, end in window.kernels:
        span = (end - start) / 1e6
        if PREDICT in name:
            pending += span
        elif any(s in name for s in K1_OWN):
            k1, pending = k1 + span + pending, 0.0
        elif any(s in name for s in K2_OWN):
            k2, pending = k2 + span + pending, 0.0
    return k1, k2


def steps_after(cfg, width):
    """T' of a padded width: each strided convolution keeps
    ceil(length / stride) frames."""
    for _ in range(cfg["conv_layer_num"]):
        width = math.ceil(width / cfg["stride"])
    return width


def k1_bound_s(cfg, batch, width):
    """Least seconds of one forward's K1 calls (every capsule layer) on a
    padded [batch, width] input."""
    steps = steps_after(cfg, width)
    return sum(sdr_bounds.bound_s(sdr_bounds.k1_counts(
        batch, steps, geometry, reference.num_iter(cfg)))[0]
        for geometry in reference.layer_shapes(cfg))


def k2_bound_s(cfg, batch, width):
    """Least seconds of one backward's K2 calls on [batch, width]."""
    steps = steps_after(cfg, width)
    return sum(sdr_bounds.bound_s(sdr_bounds.k2_counts(
        batch, steps, geometry))[0]
        for geometry in reference.layer_shapes(cfg))


def share(bound, measured):
    """The roofline share in %, None where nothing was measured."""
    return 100.0 * bound / measured if measured > 0 else None
