"""On the card, at a small size: the control (the reference in TF32 in the
program's place) fails a training cell's limits and the serving cell's,
while the program passes them. The benchmark's own runs never run it."""

import pytest

from benchmark import calibrate, harness

SEEDS = (101, 202, 303)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["srf_timit.train"])
def test_training_control_fails(card, cell):
    import torch

    failed = []
    for seed in SEEDS:
        ctx = harness.load_context(cell, seed, 20.0, False)
        ctx.traffic["buckets"] = ctx.traffic["buckets"][:1]
        ctx.traffic["pool"] = 1
        for kind, numbers, _, _ in calibrate.train_kinds(
                torch, ctx, ["sound", "control"], "cuda"):
            over = [k for k, v in numbers.items()
                    if v > ctx.limits[k]["limit"]]
            if kind == "sound":
                assert not over, numbers
            else:
                failed.append(bool(over))
    assert all(failed)


@pytest.mark.card
def test_serving_control_fails(card):
    import torch

    for seed in SEEDS:
        ctx = harness.load_context("srf_wsj.serve", seed, 5.0, False)
        numbers, _ = calibrate.serve_control(torch, ctx, "cuda")
        assert numbers["token_gap"] > ctx.limits["token_gap"]["limit"]
