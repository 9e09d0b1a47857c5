"""K5's share of its roofline in the traced train steps (%): the byte bound
of its forward and backward launches at every dropout site of those steps
over the device time of ``fused_dropout_kernel`` (``counts.cnn_kernels``)."""

from benchmark.counts import cnn_kernels


def read(record):
    window = record.get("profile")
    if window is None:
        return None
    measured = cnn_kernels.k5_device_s(window)
    if not measured:
        return None
    bound = sum(cnn_kernels.k5_bound_s(record["cfg"],
                                       *batch["feats"].shape[:2])
                for batch in record["profile_batches"])
    return 100.0 * bound / measured
