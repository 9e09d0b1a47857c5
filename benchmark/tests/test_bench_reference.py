"""The plain reference agrees with the port at a tiny size on the CPU, and
every cell's run, driven end to end there, comes out correct."""

import numpy as np
import pytest
import torch

from benchmark import harness, run, weights
from benchmark.reference import common
from benchmark.tests import tiny


@pytest.mark.parametrize("config", ["srf_wsj", "srf_timit"])
def test_forward_matches_the_port(tiny_root, config):
    from srf_tpu_torch.models.registry import build_model
    from benchmark import training

    cfg = harness.read_json(tiny_root, "benchmark", "configs",
                            config + ".json")
    ctx = harness.Context(cell={}, config=cfg, traffic={}, limits={},
                          spec={}, seed=1, seconds=1.0, trace=False,
                          device="cpu", root=tiny_root)
    model, _ = build_model(training.parse_config(ctx, "cpu"),
                           cfg["model"]["class_n"])
    params = weights.make(ctx.family.param_shapes(cfg["model"]), 123, "cpu")
    model.load_state_dict(params, strict=True)
    model.eval()
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((3, 37, 8),
                                                 dtype=np.float32))
    lengths = torch.tensor([37, 20, 9])
    with torch.no_grad():
        got = model(feats, lengths)
        want = ctx.family.forward(params, feats, lengths, cfg["model"])
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_weights_follow_the_seed():
    config = harness.read_json(harness.BENCH_DIR, "configs",
                               "srf_timit.json")
    shapes = harness.family(harness.ROOT, config).param_shapes(
        config["model"])
    a, b, c = (weights.make(shapes, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["W0"], c["W0"])


def test_served_gaps():
    logits = torch.tensor([[0.0, 1.0, 2.0],    # blank (2) best
                           [3.0, 1.0, 2.0],    # id 0 starts
                           [3.0, 1.0, 2.5],    # continues id 0
                           [0.0, 1.0, 2.0],    # blank
                           [0.0, 5.0, 2.0]])   # id 1 starts
    gaps = common.served_gaps(logits, [0, 1], [1, 4], 5, blank=2)
    assert np.allclose(gaps, 0.0)
    assert common.greedy(logits, 5, 2) == ([0, 1], [1, 4])
    # serving id 1 where id 0 is best lies 2.0 below the best
    gaps = common.served_gaps(logits, [1, 1], [1, 4], 5, blank=2)
    assert gaps.max() == pytest.approx(2.0)


@pytest.mark.parametrize("cell", ["srf_wsj.train", "srf_timit.train",
                                  "srf_wsj.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_cpu(tiny_root, cell, trace):
    line, checks = run.run(tiny.context(tiny_root, cell, trace=trace))
    assert line["correct"], checks
    assert list(line)[-1] == "checks" and checks
    spec = harness.read_json(tiny_root, "BENCHMARK.json")
    if trace:
        assert "breakdown" in line
        names = {m["name"] for m in spec["per_layer"]
                 if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) <= names
    else:
        names = {m["name"] for m in spec["end_to_end"]
                 if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
