"""``--tpu-bf16`` mixed precision in the port (``train/step.make_apply_fn``
with ``bf16=True``) against JAX's bf16 ``apply_fn``
(``srf_tpu/train/step.py:46-67``), from the same numpy weights, dropout
off (F6):

- the forwards: SRF, CNN (maxpool), STF (with its padding bias) and
  (B)LSTM at small widths, eval mode, float32 logits against JAX's. Each
  tolerance is written below and is no looser than the distance between
  JAX's bf16 and float32 logits on the same inputs, which the test also
  measures (and prints). Measured: SRF, CNN 0 (the same bf16 rounding at
  every op: the product rounded, then the bias added in bf16, as flax's
  Dense and Conv do), STF 7.2e-7, LSTM 3.3e-3 (flax's LSTM cell carries
  float32 state, so its gates promote to float32 except layer 0's input
  product, which JAX rounds to bf16 and the port takes in float32),
  against 2.5e-2 to 8.1e-2 between JAX's bf16 and float32;
- one SRF train step: the gradients of the float32 master parameters
  against JAX's bf16 step (SGD at rate 1, so the update is minus the
  gradient). Both sides round every activation to bf16, and their float32
  sums (BatchNorm's batch statistics first) are taken in other orders, so
  a few activations round the other way (10 of 2,400 at the second
  BatchNorm here), and the backward carries such flips on. So each
  gradient is held within 0.15 of its tensor's largest entry (measured up
  to 0.10, at a front-end conv bias), and the largest such distance must
  stay below that of JAX's own bf16 step from its float32 step on the same
  weights and batch (measured 0.22), which the test measures and prints;
  the loss within rtol 5e-3 (measured 2.0e-4) and the BatchNorm
  statistics within atol 1e-5;
- the port's layers with parameters (``models/layers.Linear``, ``Conv2d``,
  ``LayerNorm``) against flax's ``Dense``, ``Conv`` and ``LayerNorm`` with
  bf16 parameters, on a bf16 input and on a float32 one (which flax
  promotes to float32): bf16 bit for bit, float32 within 1e-6 (measured
  2.4e-7: sums in another order);
- the master parameters stay float32, as do the BatchNorm statistics and
  the gradients; the LSTM's frozen zero ``bias_ih`` is cast with its
  cell's weights but gets no gradient, and the EMA leaves it out.
"""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import optax
import torch

from srf_tpu.models.lstm import LstmEncoder as FlaxLstmEncoder
from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.models.stf import ConvEncoder as FlaxConvEncoder
from srf_tpu.ops.masking import get_padding_bias as jax_padding_bias
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.models import layers
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.ops.masking import get_padding_bias
from srf_tpu_torch.train import step
from srf_tpu_torch.train.state import TrainState

from _torch_parity import cnn_pair, flatten_tree, no_dropout, \
    random_flax_variables

torch.set_num_threads(1)

SRF = dict(feat_dim=40, class_n=9, enc_num=3, caps_primary_num=8,
           caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4,
           caps_class_dim=4, caps_iter=1, lpad=1, rpad=1, is_context=True,
           conv_layer_num=2, conv_filter_num=8, caps_type="naive")
CNN = dict(enc_num=6, class_n=7, feat_dim=12, nfilt_inp=4, nfilt_inn=8,
           proj_layers=3, proj_dim=16)
STF = dict(num_layers=2, d_model=16, num_heads=2, dff=32, feat_dim=12,
           vocab_n=9, nfilt=4, cnn_n=2)
LSTM = dict(num_layers=2, d_model=6, vocab_n=5, feat_dim=8,
            bidirectional=True, merge_mode="ave", is_cnnfe=True,
            conv_layer_num=2, conv_filter_num=4)
STF_DIV = 4


def _stf_kwargs(padding_bias):
    def extra(batch):
        out = -(-batch["feats"].shape[1] // STF_DIV)
        return dict(mask=padding_bias(batch["inp_len"], out, STF_DIV),
                    attention_penalty_mask=None, in_len_div=STF_DIV)
    return extra


def _family(name):
    """(flax model, port model, feat_dim, lengths, JAX and port extra
    kwargs functions)."""
    if name == "srf":
        return (FlaxSequenceRouter(**SRF), SequenceRouter(**SRF), 40,
                (40, 29), None, None)
    if name == "cnn":
        return (*cnn_pair("maxpool", **CNN), 12, (30, 21), None, None)
    if name == "stf":
        return (FlaxConvEncoder(**STF), ConvEncoder(**STF), 12, (40, 29),
                _stf_kwargs(jax_padding_bias), _stf_kwargs(get_padding_bias))
    return (FlaxLstmEncoder(**LSTM), LstmEncoder(**LSTM), 8, (24, 17), None,
            None)


# the port's bf16 logits against JAX's: each within these (atol); the
# measured distances are in the module docstring
FORWARD_ATOL = {"srf": 1e-5, "cnn": 1e-5, "stf": 1e-5, "lstm": 1e-2}


@pytest.fixture(autouse=True)
def _no_flax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)


# the port's layers against flax's (atol): bf16 bit for bit; float32 sums
# taken in another order (measured 2.4e-7, values of order 1)
LAYER_ATOL = {"bfloat16": 0.0, "float32": 1e-6}


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layer", ["dense", "conv", "layer_norm"])
def test_layers_follow_flax_dtypes(layer, x_dtype):
    rng = np.random.RandomState(3)
    bf = jnp.bfloat16
    if layer == "dense":
        x = rng.randn(2, 5, 12)
        kernel, bias = rng.randn(12, 7) / 3, rng.randn(7)
        flax_layer = flax.linen.Dense(7)
        params = {"kernel": kernel, "bias": bias}
        port = layers.Linear(12, 7)
        port_params = {"weight": kernel.T, "bias": bias}
        to_port, from_port = (lambda a: a), (lambda a: a)
    elif layer == "conv":
        x = rng.randn(2, 6, 5, 3)  # NHWC
        kernel, bias = rng.randn(3, 3, 3, 4) / 5, rng.randn(4)
        flax_layer = flax.linen.Conv(4, (3, 3), padding=1)
        params = {"kernel": kernel, "bias": bias}
        port = layers.Conv2d(3, 4, 3, padding=1)
        port_params = {"weight": kernel.transpose(3, 2, 0, 1),
                       "bias": bias}
        to_port = lambda a: a.permute(0, 3, 1, 2)  # noqa: E731
        from_port = lambda a: a.permute(0, 2, 3, 1)  # noqa: E731
    else:
        x = rng.randn(2, 5, 12) * 3 + 1
        scale, bias = 1 + 0.1 * rng.randn(12), 0.1 * rng.randn(12)
        flax_layer = flax.linen.LayerNorm(epsilon=1e-6)
        params = {"scale": scale, "bias": bias}
        port = layers.LayerNorm(12, eps=1e-6)
        port_params = {"weight": scale, "bias": bias}
        to_port, from_port = (lambda a: a), (lambda a: a)
    want = flax_layer.apply(
        {"params": {k: jnp.asarray(v, bf) for k, v in params.items()}},
        jnp.asarray(x, getattr(jnp, x_dtype)))
    with torch.no_grad():
        for name, value in port_params.items():
            getattr(port, name).copy_(torch.tensor(value.copy()))
        got = torch.func.functional_call(
            port, step.bf16_params(port),
            (to_port(torch.tensor(x).to(getattr(torch, x_dtype))),))
    got = from_port(got)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=LAYER_ATOL[x_dtype])


@pytest.mark.parametrize("family", ["srf", "cnn", "stf", "lstm"])
def test_bf16_forward_matches_jax(family):
    flax_model, model, feat_dim, lengths, jax_extra, extra = \
        _family(family)
    variables = random_flax_variables(flax_model, feat_dim, seed=1)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    no_dropout(model)
    feats = np.random.RandomState(0).randn(
        len(lengths), max(lengths), feat_dim).astype(np.float32)
    lens = np.array(lengths, np.int32)
    jax_batch = {"feats": jnp.asarray(feats), "inp_len": jnp.asarray(lens)}
    jax_logits = {}
    for bf16 in (False, True):
        apply_fn = jax_step.make_apply_fn(flax_model, jax_extra, bf16=bf16)
        jax_logits[bf16] = np.asarray(apply_fn(
            variables["params"], variables.get("batch_stats", {}), jax_batch,
            False, None)[0])
    with torch.no_grad():
        got = step.make_apply_fn(model, extra, bf16=True)(
            {"feats": torch.from_numpy(feats),
             "inp_len": torch.from_numpy(lens)}, False)
    assert got.dtype == torch.float32
    jax_bf16_vs_f32 = np.abs(jax_logits[True] - jax_logits[False]).max()
    distance = np.abs(got.numpy() - jax_logits[True]).max()
    print("%s: port bf16 vs JAX bf16 %.3g, JAX bf16 vs JAX f32 %.3g"
          % (family, distance, jax_bf16_vs_f32))
    assert FORWARD_ATOL[family] <= jax_bf16_vs_f32
    np.testing.assert_allclose(got.numpy(), jax_logits[True], rtol=0,
                               atol=FORWARD_ATOL[family])
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_step_matches_jax():
    flax_model = FlaxSequenceRouter(**SRF)
    variables = random_flax_variables(flax_model, 40, seed=3)
    rng = np.random.RandomState(5)
    lens = np.array([40, 31, 36], np.int32)
    tar_len = np.array([4, 3, 3], np.int32)
    batch = {"feats": rng.randn(3, 40, 40).astype(np.float32),
             "labels": rng.randint(1, 8, size=(3, 4)).astype(np.int32),
             "inp_len": lens, "tar_len": tar_len}
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = optax.sgd(1.0)
    steps = {}
    for bf16 in (False, True):
        jax_train = jax_step.make_train_step(
            jax_step.make_apply_fn(flax_model, bf16=bf16), tx, 4, mesh=None,
            donate=False)
        steps[bf16] = jax_train(
            JaxTrainState.create(params, tx, jax.tree.map(
                jnp.asarray, variables["batch_stats"])),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
    jax_state, jax_metrics = steps[True]
    jax_grads, jax_f32_grads = (flatten_tree(jax.tree.map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, s.params))
        for s in (jax_state, steps[False][0]))

    model = no_dropout(SequenceRouter(**SRF))
    model.load_state_dict(convert.flax_to_state_dict(variables))
    state = TrainState.create(
        model, torch.optim.SGD(model.parameters(), lr=1.0), device="cpu")
    train_step = step.make_train_step(step.make_apply_fn(model, bf16=True), 4)
    state, metrics = train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    np.testing.assert_allclose(metrics["loss_sum"].item(),
                               float(jax_metrics["loss_sum"]), rtol=5e-3)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers()
               if "running" in n)
    grads = flatten_tree(convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    assert sorted(grads) == sorted(jax_grads)

    def worst(got):
        return max(np.abs(got[k] - want).max() / np.abs(want).max()
                   for k, want in jax_grads.items())

    print("gradients: port bf16 vs JAX bf16 %.3g, JAX f32 vs JAX bf16 %.3g "
          "(of each tensor's largest entry)"
          % (worst(grads), worst(jax_f32_grads)))
    assert worst(grads) < worst(jax_f32_grads)
    for key, want in jax_grads.items():
        np.testing.assert_allclose(grads[key], want, rtol=0,
                                   atol=0.15 * np.abs(want).max(),
                                   err_msg=key)
    stats = flatten_tree(convert.state_dict_to_flax(
        model.state_dict())["batch_stats"])
    for key, want in flatten_tree(jax.tree.map(
            np.asarray, jax_state.batch_stats)).items():
        np.testing.assert_allclose(stats[key], want, rtol=0, atol=1e-5,
                                   err_msg=key)


def test_lstm_frozen_bias_stays_out_of_bf16_and_ema():
    """The LSTM's frozen zero ``bias_ih`` is cast with its layer's weights
    in the bf16 forward (one dtype a cell) but gets no gradient, does not
    move, and the EMA leaves it out."""
    model = no_dropout(LstmEncoder(**LSTM))
    state = TrainState.create(
        model, torch.optim.SGD([p for p in model.parameters()
                                if p.requires_grad], lr=0.1),
        with_ema=True, device="cpu")
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen and all(".bias_ih" in n for n in frozen)
    assert not frozen & set(state.ema)
    assert frozen <= set(step.bf16_params(model))
    rng = np.random.RandomState(2)
    batch = {"feats": torch.from_numpy(
                 rng.randn(2, 24, 8).astype(np.float32)),
             "labels": torch.tensor([[1, 2], [3, 1]], dtype=torch.int32),
             "inp_len": torch.tensor([24, 17]),
             "tar_len": torch.tensor([2, 2])}
    train_step = step.make_train_step(step.make_apply_fn(model, bf16=True),
                                      model.in_len_div, ema_decay=0.9)
    state, metrics = train_step(state, batch, 0)
    assert np.isfinite(metrics["loss_sum"].item())
    params = dict(model.named_parameters())
    assert all(params[n].grad is None and not params[n].any()
               for n in frozen)
