"""The convolutions' share of their roofline in the traced train steps (%):
the bound of every convolution call of those steps (forward, data and
weight gradients, at their padded shapes) over the device time of the
kernels the convolutions launched, whatever algorithm ran, paired with
their launches (``counts.cnn_kernels``)."""

from benchmark.counts import cnn_kernels


def read(record):
    window = record.get("profile")
    if window is None:
        return None
    measured = cnn_kernels.conv_device_s(window)
    if not measured:
        return None
    bound = sum(cnn_kernels.conv_bound_s(record["cfg"],
                                         *batch["feats"].shape[:2])
                for batch in record["profile_batches"])
    return 100.0 * bound / measured
