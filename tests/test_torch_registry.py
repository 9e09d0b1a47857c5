"""The port's registry against ``srf_tpu.models.registry.build_model``.

Every ``--model-type`` builds the family JAX builds, with the same
``in_len_div``; ``--tpu-attention-kernel`` ring and unknown values raise
JAX's ValueError, the fused dropout stays refused outside the CNN family,
and ``stf_in_len_div`` warns where the reference's formula differs.

``--tpu-routing-kernel``: every value JAX builds the SRF for
builds the port's SRF too, through its one SDR (``SDRFunction``: K1/K2 on
CUDA, the plain loop on the CPU), with the same logits as the default;
``wavefront`` builds the stack loop (``ops/routing.wavefront_sdr_stack``),
whose logits equal the default's within 2e-5 (JAX's limit for its
wavefront against its layered path); an unknown value raises ValueError in
both; and ``pallas``/``xla_flat`` with bf16 routing raise JAX's
ValueError (``wavefront``'s: ``tests/test_torch_wavefront.py``)."""

import types

import numpy as np
import pytest
import torch

from srf_tpu.models.registry import build_model as jax_build_model
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models import registry
from srf_tpu_torch.ops import routing

torch.set_num_threads(1)

KERNELS = ("auto", "xla", "xla_flat", "xla_pre", "xla_factored", "pallas",
           "wavefront", "typo")
FLAGS = [
    "--feat-dim=8", "--model-encoder-num=3", "--model-caps-primary-num=4",
    "--model-caps-primary-dim=4", "--model-caps-convolution-num=3",
    "--model-caps-convolution-dim=4", "--model-caps-class-dim=4",
    "--model-caps-type=naive", "--model-caps-context=True",
    "--model-caps-iter=1", "--model-caps-window-lpad=1",
    "--model-caps-window-rpad=1", "--model-conv-filter-num=4",
]


def _config(*extra):
    logger = Logger(name="test_torch_registry", level=Logger.WARN).logger
    return ParseOption(["registry", "--path-base=.", *FLAGS, *extra], logger,
                       is_print_opts=False).args


def _outcome(build, config):
    try:
        build(config, 9)
    except (ValueError, NotImplementedError) as exc:
        return type(exc)
    return "built"


@pytest.mark.parametrize("kernel", KERNELS)
def test_routing_kernel_values_match_jax(kernel):
    config = _config("--tpu-routing-kernel=" + kernel)
    want = _outcome(jax_build_model, config)
    got = _outcome(registry.build_model, config)
    assert got == want
    if kernel == "wavefront":
        assert got == "built"
        torch.manual_seed(0)
        reference, _ = registry.build_model(_config(), 9)
        model, _ = registry.build_model(config, 9)
        model.load_state_dict(reference.state_dict())
        feats = torch.from_numpy(
            np.random.RandomState(3).randn(2, 24, 8).astype(np.float32))
        lengths = torch.tensor([24, 17])
        with torch.inference_mode():
            torch.testing.assert_close(model.eval()(feats, lengths),
                                       reference.eval()(feats, lengths),
                                       atol=2e-5, rtol=0)
    if kernel == "typo":
        with pytest.raises(ValueError, match="unknown --tpu-routing-kernel"):
            registry.build_model(config, 9)


@pytest.mark.parametrize("kernel", KERNELS[:6])
def test_equal_function_values_route_through_sdr_function(kernel,
                                                          monkeypatch):
    calls = []
    sdr = routing.SDRFunction

    class Counted(sdr):
        @staticmethod
        def forward(ctx, *args):
            calls.append(args[0].device.type)
            return sdr.forward(ctx, *args)

    monkeypatch.setattr(routing, "SDRFunction", Counted)
    torch.manual_seed(0)
    reference, _ = registry.build_model(_config(), 9)
    model, div = registry.build_model(
        _config("--tpu-routing-kernel=" + kernel), 9)
    model.load_state_dict(reference.state_dict())
    feats = torch.from_numpy(
        np.random.RandomState(3).randn(2, 24, 8).astype(np.float32))
    lengths = torch.tensor([24, 17])
    with torch.inference_mode():
        want = reference.eval()(feats, lengths)
        calls.clear()
        got = model.eval()(feats, lengths)
    assert div == 4 and calls == ["cpu"] * 3
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["pallas", "xla_flat", "auto", "xla_pre"])
def test_bf16_routing_refusals(kernel):
    """pallas and xla_flat refuse bf16 routing with JAX's ValueError; every
    other kernel value builds the SRF with bf16 routing (it was refused
    before the bf16 variants of K1 and K2 existed)."""
    config = _config("--tpu-routing-kernel=" + kernel,
                     "--tpu-routing-bf16=True")
    if kernel in ("pallas", "xla_flat"):
        with pytest.raises(ValueError, match="does not support bf16"):
            registry.build_model(config, 9)
    else:
        model, _ = registry.build_model(config, 9)
        assert model.routing_bf16


FAMILY_FLAGS = ["--model-dimension=8", "--model-att-head-num=2",
                "--model-inner-dim=16", "--model-conv-inp-nfilt=4",
                "--model-conv-inn-nfilt=8", "--model-conv-proj-dim=16",
                "--model-encoder-num=5"]


@pytest.mark.parametrize("model_type", ["lstm", "blstm", "bilstm", "stf",
                                        "cnn", "conv", "srf"])
@pytest.mark.parametrize("cnnfe", ["True", "False"])
def test_model_types_match_jax(model_type, cnnfe):
    """Every model type builds the family JAX builds, with its in_len_div
    (the LSTM's follows its front end)."""
    config = _config(*FAMILY_FLAGS, "--model-type=" + model_type,
                     "--model-lstm-is-cnnfe=" + cnnfe)
    want, want_div = jax_build_model(config, 9)
    got, div = registry.build_model(config, 9)
    assert type(got).__name__ == type(want).__name__
    assert div == want_div
    if model_type.endswith("lstm"):
        assert got.bidirectional == want.bidirectional == (
            model_type == "blstm")
        assert got.is_cnnfe == (cnnfe == "True")


@pytest.mark.parametrize("kernel", ["auto", "plain", "blockwise", "ring",
                                    "typo"])
def test_attention_kernel_values_match_jax(kernel):
    config = _config(*FAMILY_FLAGS, "--model-type=stf",
                     "--tpu-attention-kernel=" + kernel)
    want = _outcome(jax_build_model, config)
    assert _outcome(registry.build_model, config) == want
    if want == "built":
        assert registry.build_model(config, 9)[0].attention_impl == kernel
    else:
        with pytest.raises(ValueError, match="ring" if kernel == "ring"
                           else "unknown --tpu-attention-kernel"):
            registry.build_model(config, 9)


@pytest.mark.parametrize("model_type", ["lstm", "blstm", "stf"])
def test_fused_dropout_is_refused_outside_the_cnn(model_type):
    config = _config(*FAMILY_FLAGS, "--model-type=" + model_type,
                     "--tpu-dropout-kernel=pallas")
    assert _outcome(jax_build_model, config) is ValueError
    with pytest.raises(ValueError, match="CNN family only"):
        registry.build_model(config, 9)


@pytest.mark.parametrize("layers,stride,warns", [(2, 2, False),
                                                 (3, 2, True)])
def test_stf_in_len_div_warns_where_the_reference_differs(layers, stride,
                                                          warns):
    messages = []
    logger = types.SimpleNamespace(warning=lambda *a: messages.append(a))
    config = _config("--model-conv-layer-num=%d" % layers,
                     "--model-conv-stride=%d" % stride)
    assert registry.stf_in_len_div(config, logger) == stride ** layers
    assert bool(messages) == warns
    if warns:
        assert "would give %d" % layers ** stride in messages[0][0] % (
            messages[0][1:])
