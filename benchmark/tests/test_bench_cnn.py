"""The maxout CNN's plain reference agrees with the port at a tiny size on
the CPU, its K5 masks are the port's bit for bit, the CNN cell's run comes
out correct there, and its per-layer readers read a synthetic trace."""

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, spans, weights
from benchmark.counts import cnn_kernels
from benchmark.reference import cnn, common
from benchmark.tests import test_bench_reference, tiny


def _program(tiny_root, config):
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
    return model, params, cfg["model"], ctx.family


@pytest.mark.parametrize("config", ["cnn_timit"])
@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_the_port(tiny_root, config, training):
    """Logits at float32 round-off, in eval and with K5's masks (the
    port's CPU path runs K5's plain version, the same stream)."""
    model, params, cfg, family = _program(tiny_root, config)
    model.train(training)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal(
        (3, 37, cfg["feat_dim"]), dtype=np.float32))
    lengths = torch.tensor([37, 20, 9])
    seed = common.dropout_seed(11, 1200)
    with torch.no_grad():
        got = model(feats, lengths, torch.Generator().manual_seed(seed))
        want = family.forward(params, feats, lengths, cfg, common.Dropout(
            torch.Generator().manual_seed(seed)), training=training)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k5_masks_are_the_ports(tiny_root):
    """At every dropout site of the tiny cell's forward, the reference's
    mask is ``ops.dropout.fused_dropout_plain``'s bit for bit."""
    from srf_tpu_torch.ops import dropout

    cfg = harness.read_json(tiny_root, "benchmark", "configs",
                            "cnn_timit.json")["model"]
    base = common.dropout_seed(2**31 + 7, 1201)
    sites = cnn.Sites(common.Dropout(torch.Generator().manual_seed(base)))
    gen = torch.Generator().manual_seed(0)
    checked = 0
    for index, (size, rate) in enumerate(cnn.dropout_sites(3, 41, cfg)):
        x = torch.randn(size, generator=gen) + 3.0  # no zeros of its own
        assert cnn.site_seed(base, index) == dropout.site_seed(base, index)
        want = dropout.fused_dropout_plain(
            x, dropout.site_seed(base, index), rate)
        assert torch.equal(sites(x, rate), want)
        checked += 1
    assert checked == 2 * (cfg["enc_num"] + cfg["proj_num"] - 1) + 1 == 25


@pytest.mark.parametrize("cell", ["cnn_timit.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_cpu(tiny_root, cell, trace):
    test_bench_reference.test_cell_runs_correct_on_cpu(tiny_root, cell,
                                                       trace)


def test_counts_at_the_published_widths():
    """The frozen counts at CNN-TIMIT's widths: 223.2 MFLOP a frame
    forward; 29 convolution calls a step (no data gradient for the first);
    25 dropout sites."""
    cfg = harness.read_json(harness.BENCH_DIR, "configs",
                            "cnn_timit.json")["model"]
    assert cnn.forward_flops(1, 1, cfg) == 223209072.0
    assert cnn.train_step_flops(1, 1, cfg) == 3 * 223209072.0
    calls = cnn.conv_calls(29, 241, cfg)
    assert [d for d, _, _ in calls].count("dgrad") == 9 and len(calls) == 29
    assert sum(ops for _, _, ops in calls) == 4601656005120.0
    assert len(cnn.dropout_sites(29, 241, cfg)) == 25


def _window(host, kernels):
    window = devtrace.Window()
    window.host, window.kernels = host, kernels
    window.start_us, window.end_us = 0.0, 1000.0
    return window


def _record(window, cfg):
    return {"profile": window, "cfg": cfg, "steps": 1, "window_s": 0.5,
            "flops": 0.5 * 66.9e12 * 0.4,
            "profile_batches": [{"feats": np.zeros((3, 41, 9))}]}


def _metric(name):
    spec = {"per_layer": [{"name": name}]}
    ctx = harness.Context(cell={"name": "cnn_timit.train"}, config={},
                          traffic={}, limits={}, spec=spec, seed=0,
                          seconds=1.0, trace=True)
    return harness.per_layer_metrics(ctx)[0][1]


def test_readers_on_a_synthetic_trace(monkeypatch):
    cfg = dict(harness.read_json(harness.BENCH_DIR, "configs",
                                 "cnn_timit.json")["model"], **cnn.TINY)
    host = [("aten::convolution", 10, 50), ("cudaLaunchKernel", 20, 21),
            ("aten::copy_", 25, 35), ("cudaLaunchKernel", 30, 31),
            ("aten::add", 60, 70), ("cudaLaunchKernel", 65, 66),
            ("cudaMemcpyAsync", 71, 72), ("cudaLaunchKernel", 75, 76),
            ("aten::convolution_backward", 80, 120),
            ("cuLaunchKernel", 90, 91)]
    kernels = [("implicit_gemm", 100, 200), ("nhwcToNchw", 200, 260),
               ("elementwise", 260, 270), ("Memcpy HtoD", 270, 275),
               ("void fused_dropout_kernel(float)", 280, 300),
               ("wgrad_alg", 300, 420)]
    window = _window(host, kernels)
    assert cnn_kernels.conv_device_s(window) == pytest.approx(280e-6)
    assert cnn_kernels.k5_device_s(window) == pytest.approx(20e-6)
    record = _record(window, cfg)
    conv = cnn_kernels.conv_bound_s(cfg, 3, 41)
    k5 = cnn_kernels.k5_bound_s(cfg, 3, 41)
    assert _metric("conv_roofline.train_cnn").read(record) == \
        pytest.approx(100 * conv / 280e-6)
    assert _metric("dropout_roofline.train_cnn").read(record) == \
        pytest.approx(100 * k5 / 20e-6)
    assert _metric("step_mfu.train_cnn").read(record) == pytest.approx(40.0)
    # a kernel's record lost: the run of kernels before the copy is left
    # out, the one after it still pairs
    lost = _window(host, kernels[1:])
    assert cnn_kernels.conv_device_s(lost) == pytest.approx(120e-6)
    # the copy's record lost: the runs cannot be told apart
    no_copy = _window(host, kernels[:3] + kernels[4:])
    assert _metric("conv_roofline.train_cnn").read(_record(no_copy, cfg)) \
        is None
    assert _metric("conv_roofline.train_cnn").read({"cfg": cfg}) is None
    ring = [("srf.conv.choose", 0, 2_000_000_000, 1, None, "a"),
            ("srf.step", 0, 5, 1, None, None),
            ("srf.conv.choose", 3, 500_000_003, 1, None, "b")]
    choose = _metric("conv_choose_s.train_cnn")
    monkeypatch.setattr(spans, "program_spans", lambda: ring)
    assert choose.read({}) == pytest.approx(2.5)
    monkeypatch.setattr(spans, "program_spans", lambda: ring[1:2])
    assert choose.read({}) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert choose.read({}) is None
