"""The two WSJ recipes the card checks at their own width, CNN-WSJ
(``egs/script/torch/train_cnn_wsj.sh``: the stride variant, L=15, filters
200/430, 3 x 2048 projections, stride 2, ``--model-conv-is-mp=False``) and
STF-WSJ (``train_stf_wsj.sh``: L=20, D=256, FF 1488, 4 heads, dropouts
0.3/0.4/0.3/0.4, penalty zero 1 / stripe 1 / scale 1), built from
``egs/conf/wsj.conf`` plus the recipe's flags by each package's own
``ParseOption`` and registry from the same argv (32 classes: wsj_31.vocab
and the blank):

- at full width, the port's parameter tree (``convert.state_dict_to_flax``)
  equals JAX's (``jax.eval_shape`` of ``init``) leaf by leaf in name and
  shape, and CNN-WSJ has 36 K5 sites in both (the port's forward in pallas
  mode, JAX's traced by ``jax.eval_shape``): the input dropout, 2 a conv
  (15), 2 a projection (2) and ``projv``;
- CNN-WSJ at the recipe's widths but 6 layers (5 would leave out the
  430-filter convs), 40 and 31 frames, with numpy weights carried across by
  ``convert.py``, in float64 on both sides (as ``tests/test_torch_cnn.py``:
  float32 noise through LayerNorms with eps 1e-6 is not what this holds):
  the eval logits, and a pallas-mode training forward with every K5 site
  on (each JAX site patched to apply K5's plain version, ``ops.dropout.
  fused_dropout_plain``, with the port's seed for that site, so the two
  draw the same masks; the front end's own dropout off on both sides),
  within atol 1e-8;
- STF-WSJ at its widths but 2 layers, in float32: the eval logits (no mask
  or board, as both Recognizers serve it) and a training forward with
  ``trainer_tf``'s padding bias and penalty board (dropout off on both
  sides) within atol 5e-5 (logits O(1) through 3 LayerNorms over 256
  channels; measured 2.9e-6 and 3.6e-6 here; the CNN's float64 runs
  agree to 1.2e-13), and the front end's BatchNorm
  statistics within 1e-6.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srf_tpu.models.cnn as jax_cnn
from srf_tpu.config import ParseOption as JaxParseOption
from srf_tpu.models.registry import build_model as jax_build_model
from srf_tpu.ops.attention_penalty import (
    create_attention_penalty as jax_attention_penalty)
from srf_tpu.trainer_tf import make_stf_extra_kwargs as jax_extra_kwargs
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models import cnn
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops.attention_penalty import create_attention_penalty
from srf_tpu_torch.ops.dropout import fused_dropout_plain, site_seed
from srf_tpu_torch.trainer_tf import make_stf_extra_kwargs

from _torch_parity import flatten_tree, no_dropout, random_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 32  # wsj_31.vocab's 31 symbols and the blank
LOGGER = Logger(name="test_torch_wsj_recipes", level=Logger.WARN).logger
# train_cnn_wsj.sh's model flags (stage 1), K5 at every site
CNN_WSJ = ["--model-type=cnn", "--model-conv-inp-nfilt=200",
           "--model-conv-inn-nfilt=430", "--model-conv-proj-num=3",
           "--model-conv-proj-dim=2048", "--model-conv-stride=2",
           "--model-conv-is-mp=False", "--train-lr-param-k=0.5",
           "--model-dimension=1", "--model-encoder-num=15",
           "--tpu-dropout-kernel=pallas"]
# train_stf_wsj.sh's (stage 1)
STF_WSJ = ["--model-type=stf", "--model-inner-dim=1488",
           "--train-att-dropout=0.3", "--train-inn-dropout=0.4",
           "--train-inp-dropout=0.3", "--train-res-dropout=0.4",
           "--model-ap-scale=1", "--model-ap-width-zero=1",
           "--model-ap-width-stripe=1", "--model-ap-encoder=True",
           "--model-ap-decoder=True", "--model-ap-encdec=False",
           "--model-dimension=256", "--train-lr-param-k=1.5",
           "--model-encoder-num=20"]
CNN_SITES = 1 + 2 * 15 + 2 * 2 + 1
K5_BASE_SEED = 1234


def _argv(flags, *extra):
    return ["test", "--config=%s" % os.path.join(REPO, "egs/conf/wsj.conf"),
            "--path-base=%s" % REPO, *flags, *extra]


def _pair(flags, *extra):
    """(JAX model, port model, the port's config, in_len_div), each built
    by its own package from the same argv."""
    jax_config = JaxParseOption(_argv(flags, *extra), LOGGER,
                                is_print_opts=False).args
    config = ParseOption(_argv(flags, *extra), LOGGER,
                         is_print_opts=False).args
    jax_model, jax_div = jax_build_model(jax_config, CLASSES)
    model, div = build_model(config, CLASSES)
    assert div == jax_div == 4
    return jax_model, model, config, jax_config, div


def _shapes(jax_model, frames=40):
    return jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, frames, 123)), jnp.full((1,), frames, jnp.int32),
        False))


@pytest.mark.parametrize("flags,count", [(CNN_WSJ, 21_081_130),
                                         (STF_WSJ, 21_132_768)])
def test_full_width_trees_match(flags, count):
    jax_model, model, config, _, _ = _pair(flags)
    want = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.tree.map(lambda x: x, _shapes(jax_model))).items()}
    got = {k: tuple(v.shape) for k, v in flatten_tree(
        convert.state_dict_to_flax(model.state_dict())).items()}
    assert sorted(got) == sorted(want)
    assert got == want
    params = sum(int(np.prod(s)) for k, s in got.items()
                 if k.startswith("params/"))
    assert params == count


def test_cnn_wsj_has_36_k5_sites_in_both_packages():
    jax_model, model, _, _, _ = _pair(CNN_WSJ)
    assert model.dropout_impl == "pallas" and jax_model.dropout_impl == "pallas"
    sites = []
    real = cnn.fused_dropout
    cnn.fused_dropout = lambda x, seed, rate: sites.append(
        (tuple(x.shape), rate)) or x
    try:
        with torch.no_grad():
            model.train()(torch.zeros(1, 40, 123), torch.tensor([40]),
                          torch.Generator().manual_seed(0))
    finally:
        cnn.fused_dropout = real
    assert len(sites) == CNN_SITES == 36
    # the input dropout (0.3 is wsj.conf's default), then (0.2, inner) a
    # conv and a projection, then projv's inner dropout
    rates = [rate for _, rate in sites]
    assert rates[0] == 0.1 and rates[-1] == 0.1
    assert rates[1:-1] == [0.2, 0.1] * 17
    assert [shape[-1] for shape, _ in sites[1:31:2]] == (
        [200] * 4 + [430] * 10 + [132])

    jax_sites = []

    def count(x, seed, rate):
        jax_sites.append((tuple(x.shape), rate))
        return x

    variables = _shapes(jax_model)
    original = jax_cnn.fused_dropout
    jax_cnn.fused_dropout = count
    try:
        jax.eval_shape(lambda v: jax_model.apply(
            v, jnp.zeros((1, 40, 123)), jnp.full((1,), 40, jnp.int32), True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"]), variables)
    finally:
        jax_cnn.fused_dropout = original
    assert jax_sites == sites


def _cnn6():
    jax_model, model, _, _, _ = _pair(CNN_WSJ, "--model-encoder-num=6")
    variables = random_flax_variables(jax_model, 123, seed=17)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return jax_model, model.double(), variables


def _cnn_inputs():
    rng = np.random.RandomState(17)
    return rng.randn(2, 40, 123), np.array([40, 31], np.int32)


def test_cnn_wsj_eval_logits_match_jax_float64():
    jax_model, model, variables = _cnn6()
    feats, lens = _cnn_inputs()
    with jax.enable_x64(True):
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want = np.asarray(jax_model.apply(cast, jnp.asarray(feats),
                                          jnp.asarray(lens), False))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    assert got.shape == want.shape == (2, 10, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def test_cnn_wsj_training_forward_with_k5_masks_matches_jax(monkeypatch):
    """Every K5 site on (rates 0.1 and 0.2), the masks K5's plain version
    draws in the port, applied at the same sites in JAX."""
    jax_model, model, variables = _cnn6()
    feats, lens = _cnn_inputs()
    model.conv_feat.dropout.p = 0.0  # the front end's own, not K5's
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    ordinal = iter(range(100))

    def k5_plain(x, seed, rate):
        out = fused_dropout_plain(torch.from_numpy(np.array(x)),
                                  site_seed(K5_BASE_SEED, next(ordinal)),
                                  rate)
        return jnp.asarray(out.numpy())

    monkeypatch.setattr(jax_cnn, "fused_dropout", k5_plain)
    with jax.enable_x64(True):
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, _ = jax_model.apply(
            cast, jnp.asarray(feats), jnp.asarray(lens), True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    assert next(ordinal) == 1 + 2 * 6 + 2 * 2 + 1  # every site ran
    sites = []
    real = cnn.fused_dropout

    def spy(x, seed, rate):
        sites.append(seed)
        return real(x, seed, rate)

    monkeypatch.setattr(cnn, "fused_dropout", spy)
    got = model.train()(torch.from_numpy(feats), torch.from_numpy(lens),
                        torch.Generator().manual_seed(K5_BASE_SEED))
    assert sites == [site_seed(K5_BASE_SEED, i) for i in range(18)]
    eval_logits = model.eval()(torch.from_numpy(feats),
                               torch.from_numpy(lens))
    assert (got - eval_logits).abs().max() > 1e-2  # the masks moved it
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-8)


def _stf2():
    jax_model, model, config, jax_config, div = _pair(
        STF_WSJ, "--model-encoder-num=2")
    assert model.num_heads == jax_model.num_heads == 4
    variables = random_flax_variables(jax_model, 123, seed=5)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return jax_model, model, variables, config, jax_config, div


def _stf_batch():
    rng = np.random.RandomState(5)
    lens = np.array([96, 71], np.int32)
    return rng.randn(2, 96, 123).astype(np.float32), lens


def test_stf_wsj_eval_logits_match_jax():
    jax_model, model, variables, _, _, _ = _stf2()
    feats, lens = _stf_batch()
    want = jax_model.apply(variables, jnp.asarray(feats), jnp.asarray(lens),
                           False)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    assert got.shape == (2, 24, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)


def test_stf_wsj_training_forward_with_penalty_board_matches_jax(
        monkeypatch):
    jax_model, model, variables, config, jax_config, div = _stf2()
    feats, lens = _stf_batch()
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    jax_kwargs = jax_extra_kwargs(jax_attention_penalty(jax_config, LOGGER),
                                  div)({"feats": jnp.asarray(feats),
                                        "inp_len": jnp.asarray(lens)})
    kwargs = make_stf_extra_kwargs(create_attention_penalty(config, LOGGER),
                                   div)({"feats": torch.from_numpy(feats),
                                         "inp_len": torch.from_numpy(lens)})
    assert kwargs["attention_penalty_mask"].shape[-2:] == (24, 24)
    np.testing.assert_array_equal(kwargs["attention_penalty_mask"].numpy(),
                                  np.asarray(
                                      jax_kwargs["attention_penalty_mask"]))
    want, mutated = jax_model.apply(
        variables, jnp.asarray(feats), jnp.asarray(lens), True,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
        **jax_kwargs)
    got = no_dropout(model).train()(torch.from_numpy(feats),
                                    torch.from_numpy(lens), **kwargs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=5e-5)
    stats = flatten_tree(convert.state_dict_to_flax(
        model.state_dict())["batch_stats"])
    for key, value in flatten_tree(jax.tree.map(
            np.asarray, mutated["batch_stats"])).items():
        np.testing.assert_allclose(stats[key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
