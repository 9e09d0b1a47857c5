"""The per-layer metrics' arithmetic, shared by the reader files in
``benchmark/metrics/`` (one file a metric, found by its name; a quantity
split by cell regime, such as ``step_mfu.train`` and
``step_mfu.train_timit``, reads alike). Each returns None where its record
holds nothing to read."""

from benchmark.counts import sdr_kernels
from benchmark.counts.flops import H100_PEAK_FP32


def step_mfu(record):
    """Model FLOPs of the valid frames of the window's train steps (3 x
    the forward, no recompute) over the window's seconds, as a share of
    the card's float32 peak (%)."""
    if not record.get("steps"):
        return None
    return 100.0 * record["flops"] / record["window_s"] / H100_PEAK_FP32


def sdr_roofline_train(record, kernel):
    """K1's (``kernel`` 0) or K2's (1) share of its roofline in the traced
    train steps (%): the bound of every call those steps made over the
    device time of the kernel's launches."""
    window = record.get("profile")
    if window is None:
        return None
    bound_of = (sdr_kernels.k1_bound_s, sdr_kernels.k2_bound_s)[kernel]
    bound = sum(bound_of(record["cfg"], *b["feats"].shape[:2])
                for b in record["profile_batches"])
    return sdr_kernels.share(bound, sdr_kernels.device_s(window)[kernel])


def idle_share(record):
    """1 - the union of the device's operations over the traced window's
    length (%)."""
    window = record.get("profile")
    if window is None or window.seconds <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s() / window.seconds)


def batch_mfu(record):
    """Model FLOPs of the valid frames of every served batch (its requests,
    not the front end's padding rows) over the summed seconds of the front
    end's calls into the Recognizer, as a share of the float32 peak
    (%)."""
    spent = sum(end - start for start, end, _, _ in record["calls"])
    if spent <= 0:
        return None
    return 100.0 * record["flops"] / spent / H100_PEAK_FP32


def sdr_fwd_roofline_serve(record):
    """K1's share of its roofline in the traced serving window (%): the
    bound of every K1 call of the batches served there, at their padded
    shapes, over the device time of K1's kernels."""
    window = record.get("profile")
    if window is None:
        return None
    bound = sum(sdr_kernels.k1_bound_s(record["cfg"], len(lengths),
                                       -(-max(lengths) // 128) * 128)
                for _, _, lengths, _ in record["profile_calls"])
    return sdr_kernels.share(bound, sdr_kernels.device_s(window)[0])


def batch_fill(record):
    """The mean of the front end's ``stats["batch_sizes"]`` (requests a
    batch) over ``max_batch`` (%)."""
    sizes = record["batch_sizes"]
    if not sizes:
        return None
    return 100.0 * sum(sizes) / len(sizes) / record["max_batch"]
