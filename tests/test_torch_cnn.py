"""The port's maxout CNN encoders (``srf_tpu_torch/models/cnn.py``) against
``srf_tpu.models.cnn``, same numpy weights carried across by
``srf_tpu_torch.convert``.

Tolerances. Both sides in float64 (JAX under ``jax.enable_x64``, the port
``.double()``) agree to ~1e-10 at the small sizes (enc 5-6, feat 12,
filters 4/8, two projections of 16, 7 classes), so the structure is held
at atol 1e-8. In float32 they do not meet 1e-5 at those sizes, and cannot:
a LayerNorm over 2 channels (filters 4, halved by the maxout) with eps
1e-6 divides by sqrt(var + 1e-6) where two near-equal channels make var
tiny, and flax takes var as E[x^2] - E[x]^2; float32 differences of 1e-7
then move outputs by O(1) (measured 1.3). At filters 16, proj 32 (every
LayerNorm over >= 7 channels) each float32 side is 1-5e-5 from a float64
run of the same weights through six to nine LayerNorms (measured), and the
two sides within 9e-5 of each other over 36 cases: the float32 check
there is atol 2e-4.

Cases cover time stride 1 and 2 (stride 2 runs the asymmetric (5, 3) SAME
padding), even and odd T, and ragged lengths, in eval mode and in training
mode with dropout off on both sides (flax's ``Dropout.__call__`` and
``srf_tpu.models.cnn.fused_dropout`` patched to the identity, the port's
rates set to 0), which also holds the stride variant's BatchNorm
statistics. Also: the registry, ``same_pad`` against flax, the recipe's
parameter count, and serving through ``Recognizer``.
"""

import os

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.cnn import CNNEncoder as FlaxCNNEncoder
from srf_tpu.ops.ctc_decode import greedy_decode_frames
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models import layers
from srf_tpu_torch.models.cnn import CNNEncoder, CNNStrideEncoder
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.train.state import param_count

from _torch_parity import (cnn_pair, flatten_tree, no_dropout,
                           patch_out_jax_dropout, random_flax_variables)

torch.set_num_threads(1)

FEAT_DIM, CLASS_N = 12, 7
SMALL = dict(enc_num=6, class_n=CLASS_N, feat_dim=FEAT_DIM, nfilt_inp=4,
             nfilt_inn=8, proj_layers=3, proj_dim=16)
WIDE = dict(SMALL, nfilt_inp=16, nfilt_inn=16, proj_dim=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seq_len, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, seq_len, FEAT_DIM)
    return feats, np.array([seq_len, seq_len - 5, 9], np.int32)


def _jax_forward(model, variables, feats, lengths, training, dtype):
    """flax apply in ``dtype``; in training mode also the new
    batch_stats (dropout off: the caller patches it)."""
    with jax.enable_x64(dtype == np.float64):
        cast = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        args = (cast, jnp.asarray(feats, dtype), jnp.asarray(lengths))
        if not training:
            return np.asarray(jax.jit(
                lambda v, f, l: model.apply(v, f, l, False))(*args)), None
        out, mutated = jax.jit(lambda v, f, l: model.apply(
            v, f, l, True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)}))(*args)
        return np.asarray(out), jax.tree.map(np.asarray,
                                             mutated.get("batch_stats", {}))


def _port(model, variables, dtype, dropout_impl="xla"):
    model.load_state_dict(convert.flax_to_state_dict(variables))
    model.dropout_impl = dropout_impl
    return model.to(torch.float64 if dtype == np.float64 else torch.float32)


@pytest.mark.parametrize("variant", ["maxpool", "stride"])
def test_convert_round_trip(variant, tmp_path):
    """The CNN's convs and Dense layers have no bias, and the maxpool
    variant has no batch_stats: both trees go across and back."""
    flax_model, model = cnn_pair(variant, **SMALL)
    variables = random_flax_variables(flax_model, FEAT_DIM)
    assert ("batch_stats" in variables) == (variant == "stride")
    state = convert.flax_to_state_dict(variables)
    assert "body.conv0.weight" in state and "body.conv0.bias" not in state
    model.load_state_dict(state)  # strict: names and shapes agree
    back = convert.state_dict_to_flax(model.state_dict())
    want, got = flatten_tree(variables), flatten_tree(back)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    path = tmp_path / "weights.npz"
    np.savez(path, **want)
    loaded = convert.load_npz(str(path))
    assert all(torch.equal(loaded[k], state[k]) for k in state)


@pytest.mark.parametrize("variant,stride,seq_len,enc_num", [
    ("maxpool", 2, 24, 6),
    ("maxpool", 2, 23, 5),
    ("maxpool", 1, 23, 6),
    ("maxpool", 1, 24, 5),
    ("stride", 2, 24, 6),
    ("stride", 2, 23, 5),
])
def test_eval_logits_match_flax_float64(variant, stride, seq_len, enc_num):
    kwargs = dict(SMALL, enc_num=enc_num)
    if variant == "maxpool":
        kwargs["stride"] = stride
    flax_model, model = cnn_pair(variant, **kwargs)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=seq_len)
    feats, lengths = _inputs(seq_len)
    want, _ = _jax_forward(flax_model, variables, feats, lengths, False,
                           np.float64)
    model = _port(model, variables, np.float64).eval()
    outs = []
    for impl in ("xla", "pallas"):  # dropout's kernel is moot in eval
        model.dropout_impl = impl
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(feats),
                              torch.from_numpy(lengths)))
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == want.shape
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("variant,stride", [("maxpool", 1), ("maxpool", 2),
                                            ("stride", 2)])
def test_eval_logits_match_flax_float32(variant, stride):
    kwargs = dict(WIDE, **({"stride": stride} if variant == "maxpool" else {}))
    flax_model, model = cnn_pair(variant, **kwargs)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=3)
    feats, lengths = _inputs(23, seed=3)
    feats = feats.astype(np.float32)
    want, _ = _jax_forward(flax_model, variables, feats, lengths, False,
                           np.float32)
    model = _port(model, variables, np.float32).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("variant,dropout_impl", [
    ("maxpool", "xla"), ("maxpool", "pallas"),
    ("stride", "xla"), ("stride", "pallas"),
])
def test_training_forward_matches_flax_without_dropout(variant, dropout_impl,
                                                       monkeypatch):
    patch_out_jax_dropout(monkeypatch)
    kwargs = dict(SMALL, **({"stride": 2} if variant == "maxpool" else {}))
    flax_model = cnn_pair(variant, **kwargs)[0].clone(
        dropout_impl=dropout_impl)
    model = no_dropout(cnn_pair(variant, **kwargs)[1])
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=4)
    feats, lengths = _inputs(24, seed=4)
    want, stats = _jax_forward(flax_model, variables, feats, lengths, True,
                               np.float64)
    model = _port(model, variables, np.float64, dropout_impl).train()
    got = model(torch.from_numpy(feats), torch.from_numpy(lengths),
                torch.Generator().manual_seed(0))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-8)
    got_stats = convert.state_dict_to_flax(model.state_dict()).get(
        "batch_stats", {})
    assert sorted(flatten_tree(got_stats)) == sorted(flatten_tree(stats))
    for key, value in flatten_tree(stats).items():
        np.testing.assert_allclose(flatten_tree(got_stats)[key], value,
                                   rtol=0, atol=1e-10, err_msg=key)


def _config(*flags):
    logger = Logger(name="test_torch_cnn", level=Logger.WARN).logger
    return ParseOption(
        ["test", "--config=%s" % os.path.join(REPO, "egs/conf/timit.conf"),
         "--path-base=%s" % REPO, "--path-ckpt=%s" % REPO,
         "--feat-dim=%d" % FEAT_DIM, "--model-encoder-num=5",
         "--model-conv-inp-nfilt=4", "--model-conv-inn-nfilt=8",
         "--model-conv-proj-dim=16", "--model-conv-filter-num=4",
         "--decoding-beam-width=1", *flags],
        logger, is_print_opts=False).args


@pytest.mark.parametrize("flags,cls,in_len_div", [
    (["--model-type=cnn", "--model-conv-is-mp=True"], CNNEncoder, 4),
    (["--model-type=conv", "--model-conv-is-mp=True",
      "--model-conv-stride=1"], CNNEncoder, 1),
    (["--model-type=convolution", "--model-conv-is-mp=False",
      "--tpu-dropout-kernel=pallas"], CNNStrideEncoder, 4),
    (["--model-type=cnn", "--model-conv-is-mp=True",
      "--tpu-dropout-kernel=pallas"], CNNEncoder, 4),
])
def test_registry_dispatch(flags, cls, in_len_div):
    config = _config(*flags)
    model, div = build_model(config, CLASS_N)
    assert type(model) is cls and div == in_len_div
    assert model.dropout_impl == config.tpu_dropout_kernel


def test_registry_refusals():
    with pytest.raises(ValueError, match="CNN family only"):
        build_model(_config("--model-type=srf", "--tpu-dropout-kernel=pallas",
                            "--model-caps-type=naive"), CLASS_N)
    with pytest.raises(ValueError, match="unknown --tpu-dropout-kernel"):
        build_model(_config("--model-type=cnn", "--tpu-dropout-kernel=typo"),
                    CLASS_N)
    for model_type in ("lstm", "blstm", "stf"):
        with pytest.raises(ValueError, match="CNN family only"):
            build_model(_config("--model-type=" + model_type,
                                "--tpu-dropout-kernel=pallas"), CLASS_N)
    # the LSTM and STF families build since they were ported
    # (tests/test_torch_{lstm,stf}.py hold them to JAX)
    for model_type, cls in (("lstm", LstmEncoder), ("blstm", LstmEncoder),
                            ("stf", ConvEncoder)):
        model, _ = build_model(_config("--model-type=" + model_type,
                                       "--model-dimension=8"), CLASS_N)
        assert type(model) is cls
    model, div = build_model(_config("--model-caps-type=naive",
                                     "--model-caps-window-lpad=1",
                                     "--model-caps-window-rpad=1"), CLASS_N)
    assert type(model) is SequenceRouter and div == 4


@pytest.mark.parametrize("variant", ["maxpool", "stride"])
def test_encoder_num_below_5_raises(variant):
    flax_model, _ = cnn_pair(variant, **SMALL)
    with pytest.raises(ValueError, match="encoder-num >= 5"):
        random_flax_variables(flax_model.clone(enc_num=4), FEAT_DIM)
    with pytest.raises(ValueError, match="encoder-num >= 5"):
        cnn_pair(variant, **dict(SMALL, enc_num=4))


@pytest.mark.parametrize("seq_len", [10, 11])
def test_same_pad_matches_flax(seq_len):
    """Kernel (5, 3), stride (2, 1): flax pads time (1, 2) at even T and
    (2, 2) at odd T, frequency (1, 1)."""
    rng = np.random.RandomState(seq_len)
    x = rng.randn(2, seq_len, 7, 3).astype(np.float32)  # [B, T, F, C]
    kernel = rng.randn(5, 3, 3, 4).astype(np.float32)  # HWIO
    want = flax.linen.Conv(4, (5, 3), (2, 1), padding="SAME",
                           use_bias=False).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    assert layers.same_pads(seq_len, 5, 2) == ((1, 2) if seq_len % 2 == 0
                                               else (2, 2))
    padded = torch.nn.functional.conv2d(
        layers.same_pad(nchw, (5, 3), (2, 1)), weight, stride=(2, 1))
    for got in (padded, layers.conv2d_same(nchw, weight, (2, 1))):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)


def test_recipe_parameter_count():
    """The CNN-TIMIT recipe (egs/script/train_cnn_timit.sh): L=10, filters
    128/256, 3 x 1024 projections, stride 1, maxpool, feat 123, 63
    classes: the same 4,274,990 parameters on both sides."""
    kwargs = dict(enc_num=10, class_n=63, feat_dim=123, nfilt_inp=128,
                  nfilt_inn=256, proj_layers=3, proj_dim=1024, stride=1)
    shapes = jax.eval_shape(lambda: FlaxCNNEncoder(**kwargs).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, 123)),
        jnp.full((1,), 8, jnp.int32), False))
    assert sorted(shapes) == ["params"]
    flax_count = sum(int(np.prod(x.shape))
                     for x in jax.tree.leaves(shapes["params"]))
    assert flax_count == param_count(CNNEncoder(**kwargs)) == 4_274_990


def test_recognizer_serves_the_cnn(tmp_path):
    """Recognizer over the maxpool CNN at stride 1 (in_len_div 1): the
    greedy ids are JAX's greedy decode of flax's logits over the full
    length, and every frame is inside it."""
    config = _config("--model-type=cnn", "--model-conv-is-mp=True",
                     "--model-conv-stride=1", "--model-conv-inp-nfilt=16",
                     "--model-conv-inn-nfilt=16", "--model-conv-proj-dim=32",
                     "--path-vocab=%s" % os.path.join(
                         REPO, "egs/data/timit_62.vocab"))
    flax_model = FlaxCNNEncoder.from_config(config, 63)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=6)
    recognizer = Recognizer(config, convert.flax_to_state_dict(variables),
                            device="cpu")
    assert recognizer.in_len_div == 1
    rng = np.random.RandomState(6)
    feats_list = [rng.randn(n, FEAT_DIM).astype(np.float32)
                  for n in (40, 29, 17)]
    results = recognizer.transcribe_batch_detailed(feats_list)
    feats, lengths = recognizer.pad(feats_list)
    logits, _ = _jax_forward(flax_model, variables, feats.numpy(), lengths,
                             False, np.float32)
    out, lens, _ = (np.asarray(x) for x in greedy_decode_frames(
        jnp.asarray(logits), jnp.asarray(lengths), blank_id=62))
    for i, res in enumerate(results):
        assert res["ids"] == [int(t) for t in out[i, :lens[i]]]
        assert all(0 <= f < lengths[i] for f in res["frames"])
    assert sum(len(r["ids"]) for r in results) > 0
