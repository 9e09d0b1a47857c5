"""The convolutions' algorithm choice (``srf_tpu_torch/ops/conv_choice.py``)
and the tool that measures its table: keying, the kept count or the full
search at a problem's first call in a thread, the ``conv_choices`` counter
and the ``srf.conv.choose`` span, all on the CPU (cuDNN's own choice runs
only on the card)."""

import json
import threading

import pytest
import torch
import torch.nn.functional as F

from srf_tpu_torch.ops import conv_choice
from srf_tpu_torch.tools import conv_choices as tool
from srf_tpu_torch.utils import profiler

torch.set_num_threads(1)

CARD, CUDNN = "NVIDIA H100 80GB HBM3", 92200


def _nhwc(shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    return x.contiguous(memory_format=torch.channels_last)


def test_chosen_conv_is_f_conv2d():
    """Forward and both gradients equal ``F.conv2d``'s on a channels-last
    input (the CNN's layout), stride (2, 1) and asymmetric weights."""
    x = _nhwc((2, 4, 9, 7)).requires_grad_(True)
    w = torch.randn(6, 4, 5, 3, dtype=torch.float64, requires_grad=True)
    got = conv_choice.ChosenConv2d.apply(x, w, (2, 1), (2, 1))
    want = F.conv2d(x, w, None, (2, 1), (2, 1))
    assert torch.equal(got, want)
    grad = torch.randn_like(want)
    got_grads = torch.autograd.grad(got, (x, w), grad)
    want_grads = torch.autograd.grad(want, (x, w), grad)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    # an input that takes no gradient poses no data-gradient problem
    x0 = _nhwc((2, 1, 9, 7))
    w0 = torch.randn(6, 1, 5, 3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(conv_choice.ChosenConv2d.apply(x0, w0, (1, 1), (2, 1))
                               .sum(), (w0,))
    assert torch.equal(g, torch.autograd.grad(
        F.conv2d(x0, w0, None, 1, (2, 1)).sum(), (w0,))[0])


def test_problem_key():
    x, w = _nhwc((29, 64, 241, 41)).float(), torch.zeros(128, 64, 5, 3)
    assert conv_choice.problem_key("fwd", x, w, (1, 1), (2, 1)) == \
        "fwd x29x64x241x41 w128x64x5x3 s1x1 p2x1 nhwc float32"
    first = torch.zeros(29, 241, 123)[..., None].permute(0, 3, 1, 2)
    assert conv_choice.problem_key("wgrad", first, w, [1, 1], [2, 1]) == \
        "wgrad x29x1x241x123 w128x64x5x3 s1x1 p2x1 nchw float32"


def test_kept_limit_keys_by_card_version_and_problem():
    table = {"device": CARD, "cudnn": CUDNN, "limits": {"fwd a": 2}}
    assert conv_choice.kept_limit("fwd a", CARD, CUDNN, table) == 2
    assert conv_choice.kept_limit("fwd b", CARD, CUDNN, table) is None
    assert conv_choice.kept_limit("fwd a", "NVIDIA A100", CUDNN,
                                  table) is None
    assert conv_choice.kept_limit("fwd a", CARD, 91000, table) is None


@pytest.fixture
def on_card(monkeypatch, tmp_path):
    """``_run`` as on the card: tensors report CUDA, the card and cuDNN
    version are the table's, cuDNN's flags start from their defaults, and
    a fresh thread-local record and counter."""
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"device": CARD, "cudnn": CUDNN,
                                "limits": {"fwd kept": 3}}))
    monkeypatch.setattr(conv_choice, "TABLE", str(path))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: CARD)
    monkeypatch.setattr(torch.backends.cudnn, "version", lambda: CUDNN)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark_limit", 10)
    monkeypatch.setattr(conv_choice, "_local", threading.local())
    monkeypatch.setattr(conv_choice, "conv_choices",
                        {"searched": 0, "kept": 0})
    return torch.zeros(1)


def _flags():
    cudnn = torch.backends.cudnn
    return cudnn.benchmark, cudnn.benchmark_limit


def _choices(name="srf.conv.choose"):
    return [s.key for s in profiler.spans() if s.name == name]


def test_first_call_takes_the_kept_count_once(on_card):
    before = len(_choices())
    assert conv_choice._run("fwd kept", on_card, _flags) == (True, 3)
    assert _flags() == (False, 10)  # restored
    assert conv_choice.conv_choices == {"searched": 0, "kept": 1}
    assert _choices()[before:] == ["fwd kept"]
    # later calls run with the settings as they are, and choose nothing
    assert conv_choice._run("fwd kept", on_card, _flags) == (False, 10)
    assert conv_choice.conv_choices == {"searched": 0, "kept": 1}
    assert len(_choices()) == before + 1


def test_an_unseen_problem_is_searched_in_full(on_card):
    assert conv_choice._run("dgrad unseen", on_card, _flags) == (True, 10)
    assert conv_choice.conv_choices == {"searched": 1, "kept": 0}
    assert _choices()[-1] == "dgrad unseen"


def test_another_card_searches_every_problem(on_card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "other")
    assert conv_choice._run("fwd kept", on_card, _flags) == (True, 10)
    assert conv_choice.conv_choices == {"searched": 1, "kept": 0}


def test_each_thread_chooses_again(on_card):
    """PyTorch keeps a choice per thread (autograd runs the backward in a
    thread of its own), so each thread's first call chooses."""
    conv_choice._run("fwd kept", on_card, _flags)
    seen = []
    thread = threading.Thread(target=lambda: seen.append(
        conv_choice._run("fwd kept", on_card, _flags)))
    thread.start()
    thread.join()
    assert seen == [(True, 3)]
    assert conv_choice.conv_choices == {"searched": 0, "kept": 2}


def test_cpu_calls_choose_nothing():
    before = dict(conv_choice.conv_choices)
    conv_choice.ChosenConv2d.apply(torch.randn(1, 2, 6, 5), torch.randn(3, 2, 5, 3),
                       (1, 1), (2, 1))
    assert conv_choice.conv_choices == before


def test_tool_buys_back_the_most_time_per_second_of_choice():
    """Each problem starts at its cheapest count; the shape's step-weighted
    excess over the full search is bought back where a second of choice
    buys the most, until it is within the tolerance."""
    timings = {1: {"a": (0.1, 5.0), "b": (0.1, 1.0), "c": (0.1, 3.0)},
               2: {"a": (0.2, 1.2), "b": (0.2, 1.0), "c": (0.2, 3.0)},
               4: {"a": (0.4, 1.004), "b": (0.4, 1.0), "c": (9.0, 2.0)},
               10: {"a": (20.0, 1.0), "b": (20.0, 1.01), "c": (20.0, 1.0)}}
    counts = {"2x9": {"a": 4, "b": 1, "c": 1}}
    # full search: 4 x 1.0 + 1.01 + 1.0 = 6.01 ms a step
    assert tool.choose_limits(timings, counts, 0.01) == {
        "a": 4, "b": 1, "c": 10}
    assert tool.choose_limits(timings, counts, 0.5) == {
        "a": 2, "b": 1, "c": 1}
    table = tool.make_table(
        [{"problems": {}, "counts": counts},
         {"device": "NVIDIA H100 80GB HBM3", "cudnn": 92200}]
        + [{"limit": limit, "key": key, "first_s": cost, "median_ms": ms}
           for limit, row in timings.items()
           for key, (cost, ms) in row.items()], 0.01)
    assert table["device"] == "NVIDIA H100 80GB HBM3"
    assert table["limits"] == {"a": 4, "b": 1, "c": 10}


def test_tool_captures_each_problem_once():
    """The maxpool CNN's 10 convolutions at one shape pose 5 forward, 4
    data-gradient (the features take none) and 5 weight-gradient problems,
    keyed as ``conv_choice`` keys them."""
    from srf_tpu_torch.models.cnn import CNNEncoder

    model = CNNEncoder(10, 6, 9, 16, 32, 3, 24, conv_layer_num=2,
                       stride=1, dropout_impl="pallas").train()
    feats, lengths = torch.randn(2, 12, 9), torch.tensor([12, 8])
    problems, calls = tool.capture(torch, lambda: model(
        feats, lengths, torch.Generator().manual_seed(1)).sum().backward())
    directions = [key.split()[0] for key in problems]
    assert (directions.count("fwd"), directions.count("dgrad"),
            directions.count("wgrad")) == (5, 4, 5)
    assert calls["fwd x2x8x12x3 w16x8x5x3 s1x1 p2x1 nhwc float32"] == 3
    first = "fwd x2x1x12x9 w16x1x5x3 s1x1 p2x1 nchw float32"
    assert problems[first]["w"]["shape"] == [16, 1, 5, 3]
    assert problems[first]["x"]["stride"][1] == 1
