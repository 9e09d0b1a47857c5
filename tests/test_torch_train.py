"""The port's training path against srf_tpu's, from the same numpy weights,
with dropout off on both sides (flax's ``Dropout.__call__`` patched to the
identity, the port's rates set to 0; the JAX model hard-codes 0.2 in the
front end and the encaps convs, so no flag turns those off):

- ``ConvFrontEnd`` in training mode: outputs, and BatchNorm running mean and
  variance (flax momentum 0.99 with the biased batch variance) over two
  calls; atol 1e-5 (normalised outputs of magnitude ~1; float32 sums in
  other orders, measured ~1e-6).
- The whole train step on a tiny SRF (L=3, PH=8, PD=4, CH=6, CD=4, VD=4,
  8 filters, B=2, T=24), 3 steps of ``make_train_step`` against
  ``srf_tpu.train.step.make_train_step(..., mesh=None, donate=False)``,
  Adam under Noam(k=0.05, d=1, warmup 4) with timit.conf's betas and eps:
  ``loss_sum`` each step within rtol 1e-5; every gradient of step 1 within
  1e-4 of its largest entry (measured ~5e-6: float32 sums in other orders
  through 3 routing layers, LayerNorms and CTC); parameters after step 3
  within atol 5e-5 (Adam's update is ~rate x sign(gradient) on its first
  steps, so gradient differences of ~1e-6 move a parameter by up to ~1e-5;
  measured 6e-6) and BatchNorm statistics within 1e-5; then the valid step
  on the updated state. With the JAX default routing (factored scan) here,
  and with ``routing_impl="pallas"`` (K1 and K2 in interpret mode) in
  ``test_torch_train_pallas.py``.

Also: the train state's device (the CUDA device unless the CPU is asked
for), dropout masks drawn from the step's generator, with and without one.
"""

import types

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.layers import ConvFrontEnd as FlaxConvFrontEnd
from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops.ctc import ctc_loss_from_frames as jax_ctc_loss_from_frames
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.models.layers import ConvFrontEnd, Dropout
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.train import optimizer, step
from srf_tpu_torch.train.state import TrainState, param_count

from _torch_parity import flatten_tree, random_flax_variables

torch.set_num_threads(1)

FEAT_DIM, CLASS_N, IN_LEN_DIV = 123, 63, 4
MODEL = dict(
    feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=3, caps_primary_num=8,
    caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4, caps_class_dim=4,
    caps_iter=1, lpad=1, rpad=1, is_context=True, conv_layer_num=2,
    conv_filter_num=8, caps_type="naive", inp_dropout=0.0, inn_dropout=0.0,
)
CONFIG = types.SimpleNamespace(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=1,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)


def patch_out_flax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)


def _no_dropout(model):
    for module in model.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0
    return model


def _batch(seed=5, lengths=(24, 19)):
    rng = np.random.RandomState(seed)
    lens = np.array(lengths, np.int32)
    tar_len = np.maximum(2, lens // 8).astype(np.int32)
    return {
        "feats": rng.randn(len(lens), max(lens), FEAT_DIM).astype(np.float32),
        "labels": rng.randint(1, CLASS_N - 1, size=(len(lens), tar_len.max())
                              ).astype(np.int32),
        "inp_len": lens, "tar_len": tar_len,
    }


def test_conv_front_end_training_mode_matches_flax(monkeypatch):
    patch_out_flax_dropout(monkeypatch)
    flax_fe = FlaxConvFrontEnd(cnn_n=2, nfilt=8)
    variables = random_flax_variables(flax_fe, FEAT_DIM, seed=1)
    fe = _no_dropout(ConvFrontEnd(2, 8))
    fe.load_state_dict(convert.flax_to_state_dict(variables))
    fe.train()
    rng = np.random.RandomState(2)
    stats = variables["batch_stats"]
    for seq_len, lengths in ((37, [37, 30, 9]), (40, [40, 40, 21])):
        feats = rng.randn(3, seq_len, FEAT_DIM).astype(np.float32)
        lengths = np.array(lengths, np.int32)
        want, mutated = flax_fe.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(feats), jnp.asarray(lengths), True,
            mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        got = fe(torch.from_numpy(feats), torch.from_numpy(lengths))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        got_stats = convert.state_dict_to_flax(fe.state_dict())["batch_stats"]
        for key, value in flatten_tree(stats).items():
            np.testing.assert_allclose(flatten_tree(got_stats)[key],
                                       np.asarray(value), rtol=0, atol=1e-5,
                                       err_msg=key)
    fe.eval()  # eval mode normalises with the running statistics
    want = flax_fe.apply({"params": variables["params"], "batch_stats": stats},
                         jnp.asarray(feats), jnp.asarray(lengths), False)
    with torch.inference_mode():
        got = fe(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _jax_grads(apply_fn, params, batch_stats, batch):
    def loss_fn(p):
        logits, _ = apply_fn(p, batch_stats, batch, True,
                             jax.random.PRNGKey(0))
        pe = jax_ctc_loss_from_frames(logits, batch["inp_len"], IN_LEN_DIV,
                                      batch["labels"], batch["tar_len"])
        return jnp.sum(pe) / batch["feats"].shape[0]

    return jax.jit(jax.grad(loss_fn))(params)


def check_train_step_matches_jax(routing_impl, monkeypatch):
    """3 steps of both train steps; ``routing_impl`` is the JAX model's
    (the port has one SDR path per device)."""
    patch_out_flax_dropout(monkeypatch)
    flax_model = FlaxSequenceRouter(**MODEL, routing_impl=routing_impl)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=3)
    batch = _batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    tx, _ = jax_optimizer.get_optimizer(CONFIG)
    jax_apply = jax_step.make_apply_fn(flax_model)
    params = jax.tree.map(jnp.asarray, variables["params"])
    batch_stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    jax_grads = _jax_grads(jax_apply, params, batch_stats, jax_batch)
    jax_state = JaxTrainState.create(params, tx, batch_stats)
    jax_train = jax_step.make_train_step(jax_apply, tx, IN_LEN_DIV,
                                         mesh=None, donate=False)

    model = _no_dropout(SequenceRouter(**MODEL))
    model.load_state_dict(convert.flax_to_state_dict(variables))
    opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
    state = TrainState.create(model, opt, scheduler, device="cpu")
    apply_fn = step.make_apply_fn(model)
    train_step = step.make_train_step(apply_fn, IN_LEN_DIV)

    for i in range(3):
        jax_state, jax_metrics = jax_train(jax_state, jax_batch,
                                           jax.random.PRNGKey(i))
        state, metrics = train_step(state, torch_batch, 1234)
        np.testing.assert_allclose(metrics["loss_sum"].item(),
                                   float(jax_metrics["loss_sum"]), rtol=1e-5)
        for key in ("samples", "frames"):
            assert metrics[key].item() == float(jax_metrics[key])
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
    assert state.step == int(jax_state.step) == 3

    got = flatten_tree(convert.state_dict_to_flax(model.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, {
        "params": jax_state.params, "batch_stats": jax_state.batch_stats}))
    assert sorted(got) == sorted(want)
    for key in want:
        atol = 1e-5 if key.startswith("batch_stats") else 5e-5
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)

    jax_valid = jax_step.make_valid_step(jax_apply, IN_LEN_DIV)(jax_state,
                                                                jax_batch)
    valid = step.make_valid_step(apply_fn, IN_LEN_DIV)(state, torch_batch)
    np.testing.assert_allclose(valid["loss_sum"].item(),
                               float(jax_valid["loss_sum"]), rtol=1e-5)
    assert valid["samples"].item() == 2.0
    assert param_count(model) == sum(x.size for x in want.values()) - sum(
        x.size for k, x in want.items() if k.startswith("batch_stats"))


def test_train_step_matches_jax(monkeypatch):
    check_train_step_matches_jax("auto", monkeypatch)


def test_train_state_runs_on_the_cpu_only_when_asked(monkeypatch):
    """Like every entry point of the port, the train path defaults to the
    CUDA device and raises without one rather than train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = SequenceRouter(**MODEL)
    opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrainState.create(model, opt, scheduler, device=device)
    state = TrainState.create(model, opt, scheduler, device="cpu")
    assert state.device.type == "cpu" and state.step == 0
    assert all(p.device.type == "cpu" for p in state.model.parameters())


def test_dropout_masks_come_from_the_generator():
    x = torch.ones(4000)
    drop = Dropout(0.25).train()

    def draw(seed):
        return drop(x, torch.Generator().manual_seed(seed))

    first = draw(7)
    assert torch.equal(first, draw(7))
    assert not torch.equal(first, draw(8))
    assert set(first.unique().tolist()) == {
        0.0, torch.tensor(1.0 / 0.75).item()}
    assert abs((first > 0).float().mean().item() - 0.75) < 0.03
    torch.manual_seed(7)  # no generator: the global RNG, same mask law
    unseeded = drop(x)
    assert torch.equal(unseeded, draw(7))
    torch.manual_seed(7)
    assert torch.equal(unseeded, drop(x))
    assert torch.equal(drop.eval()(x, torch.Generator()), x)


def test_train_step_dropout_follows_the_seed():
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=6).items()}
    weights = SequenceRouter(**dict(MODEL, inp_dropout=0.1, inn_dropout=0.1),
                             generator=torch.Generator().manual_seed(0))

    def first_loss(seed):
        model = SequenceRouter(**dict(MODEL, inp_dropout=0.1,
                                      inn_dropout=0.1))
        model.load_state_dict(weights.state_dict())
        opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
        state = TrainState.create(model, opt, scheduler, device="cpu")
        train_step = step.make_train_step(step.make_apply_fn(model),
                                          IN_LEN_DIV)
        return train_step(state, batch, seed)[1]["loss_sum"].item()

    assert first_loss(1234) == first_loss(1234)
    assert first_loss(1234) != first_loss(99)
