"""What the SRF cells read stays what it was: the tiny CPU cells' check
numbers and the FLOP counts of their pools and served lengths, held to the
values recorded on commit 5b2f3204d2b62bc42c27eed570f3f3d5187f8151, before
the generators reached the model through the configuration's family.

The check numbers are round-off gaps of CPU float32 kernels, which depend
on how a reduction is split between threads: they were recorded, and are
read, at one thread (seed 11, the tiny root of ``tiny.py``). The FLOP
counts are the full-size configurations' too, and are exact."""

import pytest
import torch

from benchmark import harness, run, training
from benchmark.tests import tiny

RECORDED_ON = "5b2f3204d2b62bc42c27eed570f3f3d5187f8151"
CHECKS = {
    "srf_wsj.train": {"loss": 0.0, "grad": 9.247250676783158e-07,
                      "change": 3.072484518518632e-06,
                      "change_median": 2.3538641027254655e-07},
    "srf_timit.train": {"loss": 8.561200383028105e-08,
                        "grad": 1.524703164435018e-06,
                        "change": 8.805183265703547e-07,
                        "change_median": 1.129403558669505e-07},
    "srf_wsj.serve": {"token_gap": 0.0},
}
# each host batch's train-step FLOPs: the tiny pools at seed 11, and the
# full-size pools (one batch a bucket) at seed 2**31 + 7
POOL_FLOPS = {
    "srf_wsj.train": ([1309440.0, 1260672.0, 1260672.0, 1412160.0],
                      [682509848064.0, 677515069440.0, 712805151744.0]),
    "srf_timit.train": ([890112.0, 857472.0, 960576.0, 857472.0],
                        [38801659392.0, 36712471680.0, 38153700864.0,
                         41986062720.0, 40056079104.0]),
}
# forward FLOPs of one served utterance by its length
FORWARD_FLOPS = {"tiny": {30: 134080.0, 61: 268736.0, 90: 386560.0},
                 "full": {300: 3675782400.0, 777: 9556891392.0,
                          1600: 19604172800.0}}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", sorted(CHECKS))
def test_tiny_checks_as_recorded(tiny_root, one_thread, cell):
    _, checks = run.run(tiny.context(tiny_root, cell, seed=11))
    assert {k: v["value"] for k, v in checks.items()} == CHECKS[cell], \
        RECORDED_ON


@pytest.mark.parametrize("cell", sorted(POOL_FLOPS))
def test_pool_flops_as_recorded(tiny_root, cell):
    small = tiny.context(tiny_root, cell, seed=11)
    full = harness.load_context(cell, 2**31 + 7, 20.0, False)
    got = ([b["flops"] for pool in training.make_pools(
                small.traffic, small.family, small.model, 11)
            for b in pool],
           [b["flops"] for pool in training.make_pools(
               dict(full.traffic, pool=1), full.family, full.model,
               full.seed) for b in pool])
    assert got == POOL_FLOPS[cell], RECORDED_ON


@pytest.mark.parametrize("size", sorted(FORWARD_FLOPS))
def test_served_forward_flops_as_recorded(tiny_root, size):
    ctx = (tiny.context(tiny_root, "srf_wsj.serve") if size == "tiny" else
           harness.load_context("srf_wsj.serve", 1, 20.0, False))
    got = {n: ctx.family.forward_flops(1, n, ctx.model)
           for n in FORWARD_FLOPS[size]}
    assert got == FORWARD_FLOPS[size], RECORDED_ON
