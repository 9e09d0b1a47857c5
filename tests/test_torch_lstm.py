"""The port's (B)LSTM encoder (``models/lstm.LstmEncoder``) against
srf_tpu's from the same numpy weights (``_torch_parity``; the per-gate
flax kernels carried into ``nn.LSTM``'s stacked ones by ``convert.py``), at
L=2, D=6, feat 8, 5 classes, B=2, T=24 (front end 2 x 4 filters, T'=6):

- eval logits of ``lstm`` and of ``blstm`` under each merge (ave, sum,
  mul, concat), the CNN front end on and off, within atol 1e-5 (LayerNorm
  outputs of magnitude ~1; float32 sums in another order);
- the padding quirk: one batch at two padded widths gives other logits at
  valid frames in both implementations (the backward direction reads the
  pad frames first), and the port equals JAX at each width;
- the training forward with dropout off and every gradient of
  sum(logits^2) within 1e-4 of its tensor's largest entry; the convert
  round trip (flax -> torch -> flax exact); ``bias_ih`` zero, frozen, out
  of the optimizer, and refused by ``convert`` when it is not zero;
- the per-gate initializer: each gate block of ``weight_ih`` within the
  glorot bound of [in, H], not of [in, 4H], and spread like it; each of
  ``weight_hh`` orthogonal;
- 3 train steps against srf_tpu's ``make_train_step`` for the BLSTM with
  the front end (Adam under Noam, dropout off) with
  ``tests/test_torch_train.py``'s tolerances; a port that trained both of
  nn.LSTM's biases would move the effective bias about twice as far.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.lstm import LstmEncoder as FlaxLstmEncoder
from srf_tpu.ops.ctc import ctc_loss_from_frames as jax_ctc_loss
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.train import optimizer, step
from srf_tpu_torch.train.state import TrainState, param_count

from _torch_parity import (flatten_tree, no_dropout, patch_out_jax_dropout,
                           random_flax_variables)

torch.set_num_threads(1)

FEAT_DIM, VOCAB = 8, 5
CONFIG = types.SimpleNamespace(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=6,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)
# every merge once, the front end on and off for each direction count
CASES = (("lstm", "ave", True), ("lstm", "ave", False),
         ("blstm", "ave", True), ("blstm", "sum", False),
         ("blstm", "mul", True), ("blstm", "concat", False))


def _pair(model_type="blstm", merge="ave", cnn=True, seed=1):
    kwargs = dict(num_layers=2, d_model=6, vocab_n=VOCAB, feat_dim=FEAT_DIM,
                  bidirectional=model_type == "blstm", merge_mode=merge,
                  is_cnnfe=cnn, conv_layer_num=2, conv_filter_num=4)
    flax_model = FlaxLstmEncoder(**kwargs)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=seed)
    model = LstmEncoder(**kwargs)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, model, variables


def _inputs(seed=0, lengths=(24, 17), width=None):
    rng = np.random.RandomState(seed)
    feats = np.zeros((len(lengths), width or max(lengths), FEAT_DIM),
                     np.float32)
    for i, n in enumerate(lengths):
        feats[i, :n] = rng.randn(n, FEAT_DIM)
    return feats, np.array(lengths, np.int32)


def _eval(flax_model, model, variables, feats, lens):
    want = flax_model.apply(variables, jnp.asarray(feats), jnp.asarray(lens),
                            False)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("model_type,merge,cnn", CASES)
def test_eval_logits_match_jax(model_type, merge, cnn):
    flax_model, model, variables = _pair(model_type, merge, cnn)
    got, want = _eval(flax_model, model, variables, *_inputs())
    assert got.shape == (2, 6 if cnn else 24, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_padding_quirk_is_kept():
    """Utterance 1 (17 frames) at padded widths 24 and 32: its valid
    frames' logits change with the width on both sides, and the two sides
    agree at each width."""
    flax_model, model, variables = _pair("blstm", "ave", cnn=False)
    runs = [_eval(flax_model, model, variables,
                  *_inputs(lengths=(24, 17), width=width))
            for width in (24, 32)]
    for got, want in runs:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for side in (0, 1):  # port, JAX
        narrow, wide = runs[0][side][1, :17], runs[1][side][1, :17]
        assert np.abs(narrow - wide).max() > 1e-4


def test_training_gradients_match_jax(monkeypatch):
    patch_out_jax_dropout(monkeypatch)
    flax_model, model, variables = _pair("blstm", "concat", cnn=True)
    feats, lens = _inputs(seed=3)

    def loss(params):
        out, _ = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), jnp.asarray(lens), True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jnp.sum(out * out), out

    (_, want), want_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    model = no_dropout(model).train()
    got = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (got * got).sum().backward()
    grads = flatten_tree(convert.state_dict_to_flax(
        {k: (p.grad if p.grad is not None else torch.zeros_like(p))
         for k, p in model.named_parameters()})["params"])
    want_grads = flatten_tree(jax.tree.map(np.asarray, want_grads))
    assert sorted(grads) == sorted(want_grads)
    for key, value in want_grads.items():
        np.testing.assert_allclose(grads[key], value, rtol=0,
                                   atol=1e-4 * np.abs(value).max(),
                                   err_msg=key)


def test_convert_round_trip_and_the_second_bias():
    flax_model, model, variables = _pair("blstm", "ave", cnn=True)
    state = model.state_dict()
    assert sorted(k for k in state if k.startswith("lstm0.")) == [
        "lstm0.bias_hh_l0", "lstm0.bias_hh_l0_reverse", "lstm0.bias_ih_l0",
        "lstm0.bias_ih_l0_reverse", "lstm0.weight_hh_l0",
        "lstm0.weight_hh_l0_reverse", "lstm0.weight_ih_l0",
        "lstm0.weight_ih_l0_reverse"]
    back = flatten_tree(convert.state_dict_to_flax(state))
    want = flatten_tree(variables)
    assert sorted(back) == sorted(want)
    for key in want:
        assert np.array_equal(back[key], want[key]), key
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen == [n for n in dict(model.named_parameters())
                      if ".bias_ih" in n] and len(frozen) == 4
    assert all(not state[n].any() for n in frozen)
    opt, _ = optimizer.get_optimizer(CONFIG, model.parameters())
    in_opt = {id(p) for group in opt.param_groups for p in group["params"]}
    assert not any(id(p) in in_opt for n, p in model.named_parameters()
                   if n in frozen)
    flax_count = sum(np.size(v) for k, v in flatten_tree(variables).items()
                     if k.startswith("params/"))
    assert param_count(model) == flax_count
    state["lstm1.bias_ih_l0"] = state["lstm1.bias_ih_l0"] + 1.0
    with pytest.raises(ValueError, match="bias_ih must be zero"):
        convert.state_dict_to_flax(state)


def test_per_gate_initializer():
    """flax draws each gate's input kernel from fan_avg on [in, H] and each
    recurrent kernel orthogonal on [H, H]; glorot on torch's stacked [4H,
    in] would use fan_out 4H, a bound 1.6x narrower at in = H."""
    hidden = in_dim = 64
    model = LstmEncoder(1, hidden, VOCAB, in_dim, bidirectional=True,
                        init_name="fan_avg",
                        generator=torch.Generator().manual_seed(0))
    lstm = model.lstm0
    bound = (6.0 / (in_dim + hidden)) ** 0.5
    for suffix in ("_l0", "_l0_reverse"):
        weight_ih = getattr(lstm, "weight_ih" + suffix)
        for block in weight_ih.detach().chunk(4):
            assert block.abs().max() <= bound
            # U(-b, b) has std b / sqrt(3); the stacked draw's is 0.63x
            assert abs(block.std().item() / (bound / 3 ** 0.5) - 1) < 0.05
        for block in getattr(lstm, "weight_hh" + suffix).detach().chunk(4):
            torch.testing.assert_close(block @ block.T, torch.eye(hidden),
                                       rtol=0, atol=1e-5)
        for name in ("bias_ih", "bias_hh"):
            assert not getattr(lstm, name + suffix).any()
    other = LstmEncoder(1, hidden, VOCAB, in_dim, init_name="fan_avg",
                        generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other.lstm0.weight_ih_l0, lstm.weight_ih_l0)


def _batch(seed=5, lengths=(24, 19)):
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
    flax_model, model, variables = _pair("blstm", "ave", cnn=True)
    in_len_div = model.in_len_div
    assert in_len_div == 4
    batch = _batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    tx, _ = jax_optimizer.get_optimizer(CONFIG)
    jax_apply = jax_step.make_apply_fn(flax_model)
    params = jax.tree.map(jnp.asarray, variables["params"])
    batch_stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

    def loss_fn(p):
        logits, _ = jax_apply(p, batch_stats, jax_batch, True,
                              jax.random.PRNGKey(0))
        pe = jax_ctc_loss(logits, jax_batch["inp_len"], in_len_div,
                          jax_batch["labels"], jax_batch["tar_len"])
        return jnp.sum(pe) / len(batch["inp_len"])

    jax_grads = jax.jit(jax.grad(loss_fn))(params)
    jax_state = JaxTrainState.create(params, tx, batch_stats)
    jax_train = jax_step.make_train_step(jax_apply, tx, in_len_div,
                                         mesh=None, donate=False)

    model = no_dropout(model)
    opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
    state = TrainState.create(model, opt, scheduler, device="cpu")
    train_step = step.make_train_step(step.make_apply_fn(model), in_len_div)
    for i in range(3):
        jax_state, jax_metrics = jax_train(jax_state, jax_batch,
                                           jax.random.PRNGKey(i))
        state, metrics = train_step(state, torch_batch, 1234)
        np.testing.assert_allclose(metrics["loss_sum"].item(),
                                   float(jax_metrics["loss_sum"]), rtol=1e-5)
        if i == 0:
            grads = convert.state_dict_to_flax(
                {k: (p.grad if p.requires_grad else torch.zeros_like(p))
                 for k, p in model.named_parameters()})
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
