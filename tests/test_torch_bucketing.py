"""The port's frame-budget bucket geometry (``data/bucketing.py``, its own
copy) against ``srf_tpu.data.bucketing``: exactly equal boundaries and
batch sizes over the recipes' budgets (7000 for TIMIT, 20000 for STF-TIMIT,
24000 in wsj.conf, 28000 in timit_tpu.conf) and a grid around them, 1, 4
and 8 replicas, manual buckets and the ``step_for_bucket_size`` branch
with the reference's dedup quirk; and ``round_batch_sizes``."""

import numpy as np
import pytest

from srf_tpu.data import bucketing as jax_bucketing
from srf_tpu_torch.data import bucketing

BUDGETS = (7000, 20000, 24000, 28000, 1000, 2411, 3500, 9999)


@pytest.mark.parametrize("num_gpus", [1, 4, 8])
@pytest.mark.parametrize("step_for_bucket_size", [False, True])
def test_bucket_info_equals_jax(num_gpus, step_for_bucket_size):
    for budget in BUDGETS:
        for manual in (None, [300, 500, 900], [241, 391]):
            args = (budget, num_gpus, 241, 10000, 150)
            kwargs = dict(step_for_bucket_size=step_for_bucket_size,
                          manual_bucket_batch_sizes=manual)
            got = bucketing.get_bucket_info(*args, **kwargs)
            assert got == jax_bucketing.get_bucket_info(*args, **kwargs), (
                budget, manual)
            assert len(got[1]) == len(got[0]) + 1
            for replicas in (1, num_gpus, 3):
                assert bucketing.round_batch_sizes(got[1], replicas) == \
                    jax_bucketing.round_batch_sizes(got[1], replicas)


def test_timit_recipe_buckets():
    """The SRF-TIMIT recipe's budget: TIMIT-length audio (up to ~778
    frames) fills the first five buckets."""
    boundaries, sizes = bucketing.get_bucket_info(7000, 1, 241, 10000, 150)
    assert len(boundaries) == 11
    assert boundaries[:5] == [241, 391, 541, 691, 841]
    assert sizes[:5] == [29, 17, 12, 10, 8]
    assert sizes[-1] == 1 and bucketing.round_batch_sizes(sizes, 1) == sizes


def test_step_branch_keeps_the_duplicate_boundary_quirk():
    """step_for_bucket_size=True can floor two batch sizes to one boundary;
    the reference dedups batch sizes only, so the duplicate stays."""
    rng = np.random.RandomState(0)
    seen = False
    for _ in range(200):
        args = (int(rng.randint(500, 30000)), int(rng.choice([1, 2, 4])),
                int(rng.randint(50, 400)), int(rng.randint(500, 5000)),
                int(rng.randint(1, 20)))
        got = bucketing.get_bucket_info(*args, step_for_bucket_size=True)
        assert got == jax_bucketing.get_bucket_info(
            *args, step_for_bucket_size=True), args
        seen |= len(set(got[0])) < len(got[0])
    assert seen
