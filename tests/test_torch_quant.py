"""The port's int8 weight quantization (srf_tpu_torch.ops.quant,
--tpu-serve-quant=int8) against srf_tpu.ops.quant on the same numpy
weights, on the CPU: the same leaves quantized, each q and scale bit-equal
to JAX's (taken over the axis that is the flax layout's last), the same
resident bytes (quantized_bytes), no float32 copy of a quantized weight
left among the module's parameters and buffers, and the int8 Recognizer's
logits within atol 1e-5 of the JAX model applied to dequantize_tree's
weights (float32 sums in another order; the weights are the same bits),
with the same ids; and the LSTM's, the CNN's and the STF's int8 forwards
within the same atol of their JAX models on dequantize_tree's weights."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.lstm import LstmEncoder as FlaxLstmEncoder
from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.models.stf import ConvEncoder as FlaxConvEncoder
from srf_tpu.ops.quant import dequantize_tree, quantize_tree
from srf_tpu.ops.quant import quantized_bytes as jax_quantized_bytes
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.ops.quant import (
    quantize_model, quantized_bytes, quantized_leaves,
)
from srf_tpu_torch.serve import Recognizer

from _torch_parity import cnn_pair, flatten_tree, random_flax_variables

torch.set_num_threads(1)

# a small SRF whose routing W/b, flatten kernel and routing biases pass
# JAX's 4096-element rule (and whose small convs do not)
SRF = dict(feat_dim=123, class_n=63, enc_num=3, caps_primary_num=24,
           caps_primary_dim=8, caps_conv_num=16, caps_conv_dim=8,
           caps_class_dim=8, caps_iter=1, lpad=1, rpad=1, is_context=True,
           conv_layer_num=2, conv_filter_num=16, caps_type="naive")
SRF_FLAGS = [
    "--feat-dim=123", "--model-encoder-num=3",
    "--model-caps-primary-num=24", "--model-caps-primary-dim=8",
    "--model-caps-convolution-num=16", "--model-caps-convolution-dim=8",
    "--model-caps-class-dim=8", "--model-caps-type=naive",
    "--model-caps-context=True", "--model-caps-iter=1",
    "--model-caps-window-lpad=1", "--model-caps-window-rpad=1",
    "--model-conv-filter-num=16", "--decoding-beam-width=1",
]


def _srf():
    flax_model = FlaxSequenceRouter(**SRF)
    variables = random_flax_variables(flax_model, 123, seed=2)
    model = SequenceRouter(**SRF)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, variables, model


def _lstm():
    kwargs = dict(num_layers=2, d_model=64, vocab_n=5, feat_dim=8,
                  bidirectional=True, merge_mode="ave", is_cnnfe=True,
                  conv_layer_num=2, conv_filter_num=4)
    flax_model = FlaxLstmEncoder(**kwargs)
    variables = random_flax_variables(flax_model, 8, seed=3)
    model = LstmEncoder(**kwargs)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, variables, model


def _cnn():
    flax_model, model = cnn_pair(
        "maxpool", enc_num=5, class_n=5, feat_dim=8, nfilt_inp=32,
        nfilt_inn=48, proj_layers=1, proj_dim=128)
    variables = random_flax_variables(flax_model, 8, seed=4)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, variables, model


def _stf():
    kwargs = dict(num_layers=2, d_model=64, num_heads=2, dff=128, feat_dim=8,
                  vocab_n=5, nfilt=4, cnn_n=2)
    flax_model = FlaxConvEncoder(**kwargs)
    variables = random_flax_variables(flax_model, 8, seed=5)
    model = ConvEncoder(**kwargs)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, variables, model


@pytest.mark.parametrize("family", ["lstm", "cnn", "stf"])
def test_int8_forward_matches_jax_on_dequantized_weights(family):
    """The family's int8 forward (unmasked, as the served models run)
    against the JAX model applied to dequantize_tree(quantize_tree(...)):
    the same weights' bits, float32 sums in another order."""
    flax_model, variables, model = {"lstm": _lstm, "cnn": _cnn,
                                    "stf": _stf}[family]()
    assert quantize_model(model)
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 40, 8).astype(np.float32)
    lengths = np.array([40, 31], np.int32)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats),
                           torch.from_numpy(lengths)).numpy()
    dequant = dict(variables,
                   params=dequantize_tree(quantize_tree(variables["params"])))
    want = np.asarray(flax_model.apply(dequant, jnp.asarray(feats),
                                       jnp.asarray(lengths), False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = np.asarray(flax_model.apply(variables, jnp.asarray(feats),
                                        jnp.asarray(lengths), False))
    assert np.abs(want - plain).max() > 1e-6  # the int8 weights moved it


@pytest.mark.parametrize("family", ["srf", "lstm", "cnn"])
def test_quantized_leaves_are_bit_equal_to_jax(family):
    _, variables, model = {"srf": _srf, "lstm": _lstm, "cnn": _cnn}[family]()
    want = flatten_tree(jax.device_get(quantize_tree(variables["params"])))
    quantize_model(model)
    leaves = quantized_leaves(model)
    # each q and scale back in the flax layout (the scale as a tensor of
    # q's rank goes through the same layout change)
    q_tree = convert.state_dict_to_flax(
        {name: q for name, (q, _) in leaves.items()})["params"]
    s_tree = convert.state_dict_to_flax(
        {name: s for name, (_, s) in leaves.items()})["params"]
    got_q, got_s = flatten_tree(q_tree), flatten_tree(s_tree)
    want_q = {k[: -len("/__srf_int8__q")]: v for k, v in want.items()
              if k.endswith("/__srf_int8__q")}
    want_s = {k[: -len("/__srf_int8__scale")]: v for k, v in want.items()
              if k.endswith("/__srf_int8__scale")}
    assert sorted(got_q) == sorted(want_q) and len(want_q) >= 3
    for key in want_q:
        assert got_q[key].dtype == np.int8
        np.testing.assert_array_equal(got_q[key], np.asarray(want_q[key]))
        np.testing.assert_array_equal(got_s[key].reshape(-1),
                                      np.asarray(want_s[key]))
    assert quantized_bytes(model) == jax_quantized_bytes(
        jax.device_get(quantize_tree(variables["params"])))


@pytest.mark.parametrize("family", ["srf", "lstm", "cnn"])
def test_no_float_copy_of_a_quantized_weight_stays(family):
    _, _, model = {"srf": _srf, "lstm": _lstm, "cnn": _cnn}[family]()
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    dims = quantize_model(model)
    quantized_shapes = {shapes[name] for name in dims}
    resident = list(model.named_parameters()) + list(model.named_buffers())
    for name, tensor in resident:
        assert name not in dims
        if tensor.is_floating_point():
            assert tuple(tensor.shape) not in quantized_shapes, name
    int8 = [t for _, t in resident if t.dtype == torch.int8]
    assert len(int8) == len(dims)
    # the weight reads as its dequantized value, a fresh temporary
    name = next(iter(dims))
    *path, leaf = name.split(".")
    module = model.get_submodule(".".join(path))
    assert getattr(module, leaf).dtype == torch.float32
    assert getattr(module, leaf) is not getattr(module, leaf)


def test_int8_recognizer_matches_quantized_jax(tmp_path):
    flax_model, variables, _ = _srf()
    logger = Logger(name="test_torch_quant", level=Logger.WARN).logger
    import os

    vocab = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "egs", "data", "timit_62.vocab")
    argv = ["serve", "--path-base=%s" % tmp_path, "--path-vocab=%s" % vocab,
            "--path-ckpt=%s" % tmp_path, *SRF_FLAGS]
    state = convert.flax_to_state_dict(variables)
    recognizer = Recognizer(
        ParseOption(argv + ["--tpu-serve-quant=int8"], logger,
                    is_print_opts=False).args,
        state_dict=state, device="cpu", logger=logger)
    f32 = Recognizer(ParseOption(argv, logger, is_print_opts=False).args,
                     state_dict=state, device="cpu", logger=logger)
    assert recognizer.quantized and not f32.quantized
    rng = np.random.RandomState(6)
    feats_list = [rng.randn(n, 123).astype(np.float32) for n in (150, 97)]
    feats, lengths = recognizer.pad(feats_list)
    got = recognizer.forward(feats, lengths).numpy()
    dequant = {"params": dequantize_tree(quantize_tree(variables["params"])),
               "batch_stats": variables["batch_stats"]}
    want = np.asarray(flax_model.apply(dequant, jnp.asarray(feats.numpy()),
                                       jnp.asarray(lengths), False))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - f32.forward(feats, lengths).numpy()).max() > 1e-6
    out = recognizer.transcribe_batch_detailed(feats_list)
    want_ids = np.argmax(want, axis=-1)
    for i, result in enumerate(out):
        ids = want_ids[i, : lengths[i] // 4]
        assert result["ids"] == [
            int(x) for k, x in enumerate(ids)
            if x != 62 and (k == 0 or x != ids[k - 1])]
    # an int8 model streams too: its streamed logits match its batch ones
    session = recognizer.streaming_session(chunk=8)
    session.push(feats_list[1])
    session.flush()
    t_ceil = -(-97 // 4)
    pad = np.zeros((1, 192, 123), np.float32)
    pad[0, :97] = feats_list[1]
    batch = recognizer.forward(torch.from_numpy(pad), np.array([97])).numpy()
    np.testing.assert_allclose(session.logits[:t_ceil], batch[0, :t_ceil],
                               atol=3e-5)
