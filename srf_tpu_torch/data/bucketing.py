"""Frame-budget bucket geometry (the port's own copy of
``srf_tpu/data/bucketing.py``, numpy only).

Port of the reference bucket computation
(reference: tfsr/helper/train_helper.py:269-320): given a total frame budget
per batch, produce (bucket_boundaries, bucket_batch_sizes) with
``batch_size = floor(budget / boundary)``, batch sizes floored at
``num_replicas`` and deduplicated from the tail.

:func:`round_batch_sizes` rounds every batch size down to a multiple of
the data-parallel replica count, so every global batch splits evenly
across devices (the reference relies on MirroredStrategy tolerating
uneven splits).
"""

import numpy as np


def get_bucket_info(batch_total_size, num_gpus, min_bkt, max_bkt, step,
                    step_for_bucket_size=False, manual_bucket_batch_sizes=None):
    """(bucket_boundaries, bucket_batch_sizes) for a frame budget.

    Known reference quirk (step_for_bucket_size=True branch, unreachable
    from the trainers, which pass False): consecutive batch sizes can
    floor to the SAME boundary; the dedup loop removes duplicate batch
    sizes only, so a duplicated boundary creates a bucket that can never
    fill (first-match assignment). Ported verbatim for parity.
    """
    bucket_boundaries = []
    bucket_batch_sizes = []
    if step_for_bucket_size and manual_bucket_batch_sizes is None:
        max_buckets = int(np.floor(batch_total_size / min_bkt))
        for batch_size in range(max_buckets, num_gpus, -step):
            boundary = int(np.floor(batch_total_size / batch_size))
            if batch_size > num_gpus:
                bucket_batch_sizes.append(batch_size)
            else:
                break
            bucket_boundaries.append(boundary if boundary < max_bkt else max_bkt)
            if boundary >= max_bkt:
                break
        bucket_batch_sizes.append(num_gpus)
    else:
        boundaries = (
            manual_bucket_batch_sizes
            if manual_bucket_batch_sizes
            else range(min_bkt, max_bkt + step, step)
        )
        for boundary in boundaries:
            batch_size = int(np.floor(batch_total_size / boundary))
            if batch_size > num_gpus:
                bucket_batch_sizes.append(batch_size)
            else:
                break
            bucket_boundaries.append(boundary)
        bucket_batch_sizes.append(num_gpus)

    # removing duplicated sizes (keep the largest boundary per batch size)
    prev = -1
    for i in reversed(range(len(bucket_boundaries))):
        if bucket_batch_sizes[i] == prev:
            bucket_boundaries.pop(i)
            bucket_batch_sizes.pop(i)
        prev = bucket_batch_sizes[i]

    return bucket_boundaries, bucket_batch_sizes


def round_batch_sizes(bucket_batch_sizes, num_replicas):
    """Round batch sizes down to multiples of ``num_replicas`` (min 1x)."""
    rounded = []
    for size in bucket_batch_sizes:
        size = max(num_replicas, (size // num_replicas) * num_replicas)
        rounded.append(size)
    return rounded
