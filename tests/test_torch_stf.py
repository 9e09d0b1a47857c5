"""The port's Speech-Transformer (``models/stf.ConvEncoder``) against
srf_tpu's from the same numpy weights (``_torch_parity.random_flax_variables``
carried by ``convert.py``), at L=2, D=16, 2 heads, FF 32, 2 x 4-filter
front end, feat 12, 9 classes, B=2, T=40 (T'=10), the padding bias and
the penalty board of the STF-TIMIT recipe (zero 1, stripe 1, scale 1):

- eval logits, plain and blockwise (against JAX's plain), within atol 2e-5;
- the training forward with dropout off on both sides (flax's Dropout
  patched to the identity, the port's rates 0): logits (atol 2e-5) and the
  front end's BatchNorm statistics (atol 1e-6), and every gradient of
  sum(logits^2) within 1e-4 of its tensor's largest entry;
- the three ``stage`` values, ``auto``'s choice, ``from_config``'s
  penalty gate and the convert round trip (flax -> torch -> flax exact);
- 3 train steps of ``train.step.make_train_step`` with
  ``trainer_tf.make_stf_extra_kwargs`` against srf_tpu's
  ``make_train_step(make_apply_fn(model, make_stf_extra_kwargs(...)))``,
  Adam under Noam, dropout off, with ``tests/test_torch_train.py``'s
  tolerances: loss within rtol 1e-5 each step, step 1's gradients within
  1e-4 of their largest entry, parameters after step 3 within atol 5e-5
  and BatchNorm statistics within 1e-5.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.stf import ConvEncoder as FlaxConvEncoder
from srf_tpu.ops.attention_penalty import AttentionPenalty as JaxPenalty
from srf_tpu.ops.masking import get_padding_bias as jax_padding_bias
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu.trainer_tf import make_stf_extra_kwargs as jax_extra_kwargs
from srf_tpu_torch import convert, trainer_tf
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.ops.attention_penalty import AttentionPenalty
from srf_tpu_torch.ops.blockwise_attention import PenaltyParams
from srf_tpu_torch.ops.masking import get_padding_bias
from srf_tpu_torch.train import optimizer, step
from srf_tpu_torch.train.state import TrainState

from _torch_parity import (flatten_tree, no_dropout, patch_out_jax_dropout,
                           random_flax_variables)

torch.set_num_threads(1)

FEAT_DIM, VOCAB, DIV = 12, 9, 4
PENALTY = (1, 1, 1.0)  # train_stf_timit.sh's zero width, stripe, scale
N_STRIPES = len(range(PENALTY[0] - 1, 2500, PENALTY[1]))
KWARGS = dict(num_layers=2, d_model=16, num_heads=2, dff=32,
              feat_dim=FEAT_DIM, vocab_n=VOCAB, nfilt=4, cnn_n=2)
CONFIG = types.SimpleNamespace(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=16,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)


def _pair(**extra):
    flax_model = FlaxConvEncoder(**KWARGS, penalty_params=(
        *PENALTY, N_STRIPES), **extra)
    model = ConvEncoder(**KWARGS, penalty_params=PenaltyParams(
        *PENALTY, N_STRIPES), **extra)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=1)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, model, variables


def _inputs(seed=0, lengths=(40, 29)):
    rng = np.random.RandomState(seed)
    feats = rng.randn(len(lengths), max(lengths), FEAT_DIM).astype(np.float32)
    return feats, np.array(lengths, np.int32)


def _jax_kwargs(lens, frames):
    out = -(-frames // DIV)
    return dict(mask=jax_padding_bias(jnp.asarray(lens), out, DIV),
                attention_penalty_mask=JaxPenalty(2500, 2, *PENALTY)
                .penalty(out), in_len_div=DIV)


def _torch_kwargs(lens, frames, board=True):
    out = -(-frames // DIV)
    return dict(mask=get_padding_bias(torch.from_numpy(lens), out, DIV),
                attention_penalty_mask=(AttentionPenalty(2500, 2, *PENALTY)
                                        .penalty(out) if board else None),
                in_len_div=DIV)


@pytest.mark.parametrize("impl", ["plain", "blockwise"])
def test_eval_logits_match_jax(impl):
    flax_model, model, variables = _pair(attention_impl="plain")
    feats, lens = _inputs()
    want = flax_model.apply(variables, jnp.asarray(feats), jnp.asarray(lens),
                            False, **_jax_kwargs(lens, feats.shape[1]))
    model.attention_impl = impl
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(lens),
                           **_torch_kwargs(lens, feats.shape[1]))
    assert got.shape == (2, 10, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_training_forward_and_gradients_match_jax(monkeypatch):
    patch_out_jax_dropout(monkeypatch)
    flax_model, model, variables = _pair(attention_impl="plain")
    feats, lens = _inputs(seed=3)
    kwargs = _jax_kwargs(lens, feats.shape[1])

    def loss(params):
        out, mutated = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), jnp.asarray(lens), True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"], **kwargs)
        return jnp.sum(out * out), (out, mutated["batch_stats"])

    (_, (want, want_stats)), want_grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    model = no_dropout(model).train()
    got = model(torch.from_numpy(feats), torch.from_numpy(lens),
                **_torch_kwargs(lens, feats.shape[1]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    (got * got).sum().backward()
    tree = convert.state_dict_to_flax(model.state_dict())
    got_stats = flatten_tree(tree["batch_stats"])
    for key, value in flatten_tree(jax.tree.map(np.asarray,
                                                want_stats)).items():
        np.testing.assert_allclose(got_stats[key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
    grads = flatten_tree(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()})["params"])
    want_grads = flatten_tree(jax.tree.map(np.asarray, want_grads))
    assert sorted(grads) == sorted(want_grads)
    for key, value in want_grads.items():
        np.testing.assert_allclose(grads[key], value, rtol=0,
                                   atol=1e-4 * np.abs(value).max(),
                                   err_msg=key)


def test_stages_compose_the_whole_forward():
    flax_model, model, variables = _pair(attention_impl="plain")
    feats, lens = _inputs(seed=4)
    feats_t, lens_t = torch.from_numpy(feats), torch.from_numpy(lens)
    kwargs = _torch_kwargs(lens, feats.shape[1])
    model.eval()
    with torch.inference_mode():
        emb, impl = model(feats_t, lens_t, stage="embed", **kwargs)
        want_emb, want_impl = flax_model.apply(
            variables, jnp.asarray(feats), jnp.asarray(lens), False,
            stage="embed", **_jax_kwargs(lens, feats.shape[1]))
        assert impl == want_impl == "plain"
        np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=0,
                                   atol=2e-5)
        for i in range(2):
            emb = getattr(model, "enc%d" % i)(
                emb, kwargs["mask"], kwargs["attention_penalty_mask"])
        head = model(emb, stage="head")
        want_head = flax_model.apply(variables, jnp.asarray(emb.numpy()),
                                     stage="head")
        np.testing.assert_allclose(head.numpy(), np.asarray(want_head),
                                   rtol=0, atol=2e-5)
        assert torch.allclose(head, model(feats_t, lens_t, **kwargs),
                              rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown stage"):
        model(feats_t, lens_t, stage="embeds")


def test_auto_chooses_as_jax():
    model = ConvEncoder(**KWARGS)  # 2 heads
    for training in (True, False):
        model.train(training)
        flax_model = FlaxConvEncoder(**KWARGS)
        for batch, seq_len in ((82, 61), (8, 2047), (8, 2048), (30, 1600),
                               (29, 1601), (1, 5000)):
            want = ("blockwise" if (4.0 * batch * 2 * seq_len ** 2 > 6e8
                                    if training else seq_len >= 2048)
                    else "plain")
            assert model.choose_impl(batch, seq_len) == want
        assert flax_model.attention_impl == model.attention_impl == "auto"
    # the STF-TIMIT recipe trains on the plain path: 20000-frame buckets
    # are at most 82 x 241 frames, T' = 61
    assert model.train().choose_impl(82, 61) == "plain"
    model.attention_impl = "blockwise"
    assert model.choose_impl(1, 1) == "blockwise"


def test_from_config_penalty_gate():
    def config(**kw):
        base = dict(model_encoder_num=2, model_dimension=16,
                    model_att_head_num=2, model_inner_dim=32,
                    feat_dim=FEAT_DIM, train_inp_dropout=0.3,
                    train_inn_dropout=0.4, train_res_dropout=0.4,
                    train_att_dropout=0.3, model_conv_filter_num=4,
                    model_conv_layer_num=2, model_initializer="fan_avg",
                    model_ap_encoder=True, model_ap_decoder=True,
                    model_ap_encdec=False, model_ap_width_zero=1,
                    model_ap_width_stripe=1, model_ap_scale=1.0,
                    tpu_attention_kernel="auto")
        return types.SimpleNamespace(**dict(base, **kw))

    for kw in ({}, dict(model_ap_encoder=False, model_ap_decoder=False),
               dict(model_ap_scale=0.0), dict(model_ap_width_stripe=3)):
        got = ConvEncoder.from_config(config(**kw), VOCAB)
        want = FlaxConvEncoder.from_config(config(**kw), VOCAB)
        assert got.penalty_params == (
            None if want.penalty_params is None
            else PenaltyParams(*want.penalty_params))
        assert got.enc1.mha.penalty_params == got.penalty_params
    model = ConvEncoder.from_config(config(), VOCAB)
    assert model.enc0.mha.att_dropout.p == 0.3
    assert model.enc0.ffn.dropout.p == model.enc0.res_dropout.p == 0.4


def test_convert_round_trip_is_exact():
    _, model, variables = _pair()
    back = convert.state_dict_to_flax(model.state_dict())
    want, got = flatten_tree(variables), flatten_tree(back)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_initial_weights_follow_flax_inits():
    model = ConvEncoder(**KWARGS, init_name="fan_avg",
                        generator=torch.Generator().manual_seed(0))
    weight = model.enc0.ffn.ff1.weight  # [32, 16], glorot
    assert weight.abs().max() <= (6 / (16 + 32)) ** 0.5
    proj = model.proj.weight  # lecun_normal: truncated at 2 std
    std = (1 / 16) ** 0.5 / 0.87962566103423978
    assert proj.abs().max() <= 2 * std
    assert model.enc0.mha.wo.bias.abs().max() == 0


def _batch(seed=5, lengths=(40, 31)):
    rng = np.random.RandomState(seed)
    lens = np.array(lengths, np.int32)
    tar_len = np.maximum(2, lens // 8).astype(np.int32)
    return {
        "feats": rng.randn(len(lens), max(lens), FEAT_DIM).astype(np.float32),
        "labels": rng.randint(1, VOCAB - 1, size=(len(lens), tar_len.max())
                              ).astype(np.int32),
        "inp_len": lens, "tar_len": tar_len,
    }


def test_train_steps_match_jax(monkeypatch):
    patch_out_jax_dropout(monkeypatch)
    flax_model, model, variables = _pair()
    batch = _batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    tx, _ = jax_optimizer.get_optimizer(CONFIG)
    jax_apply = jax_step.make_apply_fn(
        flax_model, jax_extra_kwargs(JaxPenalty(2500, 2, *PENALTY), DIV))
    params = jax.tree.map(jnp.asarray, variables["params"])
    batch_stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

    def loss_fn(p):
        from srf_tpu.ops.ctc import ctc_loss_from_frames

        logits, _ = jax_apply(p, batch_stats, jax_batch, True,
                              jax.random.PRNGKey(0))
        pe = ctc_loss_from_frames(logits, jax_batch["inp_len"], DIV,
                                  jax_batch["labels"], jax_batch["tar_len"])
        return jnp.sum(pe) / len(batch["inp_len"])

    jax_grads = jax.jit(jax.grad(loss_fn))(params)
    jax_state = JaxTrainState.create(params, tx, batch_stats)
    jax_train = jax_step.make_train_step(jax_apply, tx, DIV, mesh=None,
                                         donate=False)

    model = no_dropout(model)
    opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
    state = TrainState.create(model, opt, scheduler, device="cpu")
    apply_fn = step.make_apply_fn(model, trainer_tf.make_stf_extra_kwargs(
        AttentionPenalty(2500, 2, *PENALTY), DIV))
    train_step = step.make_train_step(apply_fn, DIV)
    for i in range(3):
        jax_state, jax_metrics = jax_train(jax_state, jax_batch,
                                           jax.random.PRNGKey(i))
        state, metrics = train_step(state, torch_batch, 1234)
        np.testing.assert_allclose(metrics["loss_sum"].item(),
                                   float(jax_metrics["loss_sum"]), rtol=1e-5)
        if i == 0:
            grads = convert.state_dict_to_flax(
                {k: p.grad for k, p in model.named_parameters()})
            got, want = (flatten_tree(grads["params"]),
                         flatten_tree(jax.tree.map(np.asarray, jax_grads)))
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_allclose(
                    got[key], want[key], rtol=0,
                    atol=1e-4 * np.abs(want[key]).max(), err_msg=key)
    got = flatten_tree(convert.state_dict_to_flax(model.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, {
        "params": jax_state.params, "batch_stats": jax_state.batch_stats}))
    assert sorted(got) == sorted(want)
    for key in want:
        atol = 1e-5 if key.startswith("batch_stats") else 5e-5
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
