"""The port's training extras against srf_tpu's, from the same numpy
weights, with dropout off on both sides (F6):

- gradient accumulation: one update of ``make_train_step(accum_steps=k)``
  on the small SRF of ``test_torch_train.py`` (its front end has
  BatchNorm, whose statistics move once per microbatch) at a batch of 4
  with k 2, and with 3, which the divisor rule takes down to 2, against
  ``srf_tpu.train.step.make_train_step(accum_steps=k)``. The optimizer is
  SGD at rate 1, so each side's update is minus its summed gradient:
  ``loss_sum`` within rtol 1e-5, every gradient within 1e-4 of its
  largest entry and the BatchNorm statistics within atol 1e-5
  (``test_torch_train.py``'s tolerances; measured: gradients up to
  4.6e-6 of their largest entry, statistics up to 3.1e-7);
- EMA: 3 Adam steps at decay 0.9, the EMA within atol 5e-5 of JAX's
  ``ema_params`` (the parameters' tolerance there; measured 4.1e-6), a copy
  and not an alias of the parameters;
- the checkpoint: without EMA its dict has the keys it had before EMA
  existed; with EMA ``average_checkpoints`` averages ``"ema"`` as it does
  the model;
- decoding and serving: ``--tpu-decode-ema`` decode (``trainer_sr``'s
  ``decode_with_ema`` and logits function) and the ``Recognizer`` give
  JAX's eval-mode logits on the EMA weights with the live BatchNorm
  statistics, atol 1e-5 (measured 2.9e-6); a checkpoint without EMA
  raises JAX's ValueError;
- the trainers run each flag on the verify skill's tiny corpus:
  ``test_torch_trainer_cli.py`` and ``test_torch_trainer_tf.py``.
"""

import logging
import types

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import optax
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert, trainer_sr
from srf_tpu_torch.config import ParseOption
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.train import optimizer, step
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils import checkpoint

from _torch_parity import flatten_tree, no_dropout, random_flax_variables

torch.set_num_threads(1)

FEAT_DIM, CLASS_N, IN_LEN_DIV = 123, 63, 4
MODEL = dict(
    feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=3, caps_primary_num=8,
    caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4, caps_class_dim=4,
    caps_iter=1, lpad=1, rpad=1, is_context=True, conv_layer_num=2,
    conv_filter_num=8, caps_type="naive", inp_dropout=0.0, inn_dropout=0.0,
)
ADAM = types.SimpleNamespace(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=1,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)
QUIET = logging.getLogger("test_torch_train_extras")
QUIET.setLevel(logging.ERROR)


@pytest.fixture(autouse=True)
def _no_flax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)


def _batch(lengths=(24, 19, 22, 16), seed=5):
    rng = np.random.RandomState(seed)
    lens = np.array(lengths, np.int32)
    tar_len = np.maximum(2, lens // 8).astype(np.int32)
    return {
        "feats": rng.randn(len(lens), max(lens), FEAT_DIM).astype(np.float32),
        "labels": rng.randint(1, CLASS_N - 1, size=(len(lens), tar_len.max())
                              ).astype(np.int32),
        "inp_len": lens, "tar_len": tar_len,
    }


@pytest.fixture(scope="module")
def weights():
    flax_model = FlaxSequenceRouter(**MODEL)
    return flax_model, random_flax_variables(flax_model, FEAT_DIM, seed=3)


def _port_model(variables, params=None):
    model = no_dropout(SequenceRouter(**MODEL))
    tree = dict(variables, params=params if params is not None
                else variables["params"])
    model.load_state_dict(convert.flax_to_state_dict(tree))
    return model


def _assert_tree_close(got, want, atol_of):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=atol_of(want[key]), err_msg=key)


@pytest.mark.parametrize("accum,k", [(2, 2), (3, 2)])
def test_accumulated_step_matches_jax(weights, accum, k):
    flax_model, variables = weights
    batch = _batch()
    jax_batch = {key: jnp.asarray(v) for key, v in batch.items()}
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    tx = optax.sgd(1.0)
    jax_state = JaxTrainState.create(params, tx, stats)
    jax_train = jax_step.make_train_step(
        jax_step.make_apply_fn(flax_model), tx, IN_LEN_DIV, mesh=None,
        donate=False, accum_steps=accum)
    jax_state, jax_metrics = jax_train(jax_state, jax_batch,
                                       jax.random.PRNGKey(0))
    jax_grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             params, jax_state.params)

    model = _port_model(variables)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    state = TrainState.create(model, opt, device="cpu")
    assert len(step.microbatches(batch, accum)) == k
    train_step = step.make_train_step(step.make_apply_fn(model), IN_LEN_DIV,
                                      accum_steps=accum)
    state, metrics = train_step(
        state, {key: torch.from_numpy(v) for key, v in batch.items()}, 7)
    np.testing.assert_allclose(metrics["loss_sum"].item(),
                               float(jax_metrics["loss_sum"]), rtol=1e-5)
    assert metrics["samples"].item() == 4.0
    grads = convert.state_dict_to_flax(
        {name: p.grad for name, p in model.named_parameters()})["params"]
    _assert_tree_close(grads, jax_grads,
                       lambda w: 1e-4 * np.abs(w).max())
    got_stats = convert.state_dict_to_flax(model.state_dict())["batch_stats"]
    _assert_tree_close(got_stats, jax.tree.map(np.asarray,
                                               jax_state.batch_stats),
                       lambda w: 1e-5)


def test_microbatches_take_the_largest_divisor():
    batch = {"feats": torch.zeros(6, 2, 1), "inp_len": np.arange(6)}
    assert [len(step.microbatches(batch, k)) for k in (1, 2, 3, 4, 5, 6, 9)
            ] == [1, 2, 3, 3, 3, 6, 6]
    parts = step.microbatches(batch, 4)
    assert [list(p["inp_len"]) for p in parts] == [[0, 1], [2, 3], [4, 5]]


def test_ema_matches_jax_and_is_a_copy(weights):
    flax_model, variables = weights
    batch = _batch()
    jax_batch = {key: jnp.asarray(v) for key, v in batch.items()}
    tx, _ = jax_optimizer.get_optimizer(ADAM)
    jax_state = JaxTrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]), tx,
        jax.tree.map(jnp.asarray, variables["batch_stats"]), with_ema=True)
    jax_train = jax_step.make_train_step(
        jax_step.make_apply_fn(flax_model), tx, IN_LEN_DIV, mesh=None,
        donate=False, ema_decay=0.9)

    model = _port_model(variables)
    opt, scheduler = optimizer.get_optimizer(ADAM, model.parameters())
    state = TrainState.create(model, opt, scheduler, with_ema=True,
                              device="cpu")
    params = dict(model.named_parameters())
    assert set(state.ema) == set(params)
    for name, value in state.ema.items():
        assert value.data_ptr() != params[name].data_ptr()
        assert torch.equal(value, params[name])
    train_step = step.make_train_step(step.make_apply_fn(model), IN_LEN_DIV,
                                      ema_decay=0.9)
    torch_batch = {key: torch.from_numpy(v) for key, v in batch.items()}
    for i in range(3):
        jax_state, _ = jax_train(jax_state, jax_batch, jax.random.PRNGKey(i))
        state, _ = train_step(state, torch_batch, 1234)
    # the EMA trails the parameters: neither equal to them nor to the start
    moved = sum(float((state.ema[n] - params[n].detach()).abs().max())
                for n in params)
    assert moved > 0.0
    _assert_tree_close(convert.ema_to_flax(state.ema),
                       jax.tree.map(np.asarray, jax_state.ema_params),
                       lambda w: 5e-5)
    assert flatten_tree(convert.ema_to_flax(convert.ema_from_flax(
        jax.tree.map(np.asarray, jax_state.ema_params)))).keys() == \
        flatten_tree(jax.tree.map(np.asarray, jax_state.ema_params)).keys()


def _tiny_state(variables, with_ema):
    model = _port_model(variables)
    opt, scheduler = optimizer.get_optimizer(ADAM, model.parameters())
    return TrainState.create(model, opt, scheduler, with_ema=with_ema,
                             device="cpu")


def test_checkpoint_keeps_its_keys_and_averages_the_ema(weights, tmp_path):
    _, variables = weights
    assert set(trainer_sr.state_to_tree(_tiny_state(variables, False))) == {
        "step", "model", "optimizer", "scheduler"}
    manager = checkpoint.CheckpointManager(str(tmp_path))
    emas = []
    for step_no, seed in ((1, 1), (2, 2)):
        state = _tiny_state(variables, True)
        rng = np.random.RandomState(seed)
        state.ema = {k: torch.from_numpy(rng.randn(*v.shape).astype(
            np.float32)) for k, v in state.ema.items()}
        emas.append(state.ema)
        state.step = step_no
        tree = trainer_sr.state_to_tree(state)
        assert set(tree) == {"step", "model", "optimizer", "scheduler", "ema"}
        manager.save(step_no, tree)
    averaged, steps = checkpoint.average_checkpoints(str(tmp_path), 2)
    assert steps == [1, 2]
    for name, value in averaged["ema"].items():
        want = ((emas[0][name].double() + emas[1][name].double()) / 2).float()
        assert torch.equal(value, want), name


def _serve_config(tmp_path, *extra):
    import os

    vocab = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "egs", "data", "timit_62.vocab")
    argv = ["serve", "--path-base=%s" % tmp_path, "--path-vocab=%s" % vocab,
            "--path-ckpt=%s" % (tmp_path / "ckpt"), "--feat-dim=123",
            "--model-encoder-num=3", "--model-caps-primary-num=8",
            "--model-caps-primary-dim=4", "--model-caps-convolution-num=6",
            "--model-caps-convolution-dim=4", "--model-caps-class-dim=4",
            "--model-caps-type=naive", "--model-caps-context=True",
            "--model-caps-iter=1", "--model-caps-window-lpad=1",
            "--model-caps-window-rpad=1", "--model-conv-filter-num=8",
            "--decoding-beam-width=1", "--device=cpu", *extra]
    return ParseOption(argv, QUIET, is_print_opts=False).args


def _ema_checkpoint(variables, tmp_path, with_ema=True):
    """A port checkpoint of ``variables`` with a perturbed EMA (numpy,
    as the flax tree); returns that EMA tree."""
    rng = np.random.RandomState(21)
    ema = jax.tree.map(lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(
        np.float32), variables["params"])
    state = _tiny_state(variables, with_ema)
    if with_ema:
        state.ema = convert.ema_from_flax(ema)
    state.step = 1
    manager = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(1, trainer_sr.state_to_tree(state))
    return ema


def test_decode_ema_and_recognizer_give_jax_logits(weights, tmp_path):
    flax_model, variables = weights
    ema = _ema_checkpoint(variables, tmp_path)
    feats = np.random.RandomState(4).randn(2, 40, FEAT_DIM).astype(
        np.float32)
    lengths = np.array([40, 33], np.int32)
    want = np.asarray(flax_model.apply(
        {"params": ema, "batch_stats": variables["batch_stats"]},
        jnp.asarray(feats), jnp.asarray(lengths), False))

    config = _serve_config(tmp_path, "--tpu-decode-ema=True")
    recognizer = Recognizer(config, device="cpu")
    with torch.inference_mode():
        got = recognizer.model(torch.from_numpy(feats),
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    # trainer_sr's decode mode: the checkpoint, then decode_with_ema
    state = TrainState.create(SequenceRouter(**MODEL), None, with_ema=True,
                              device="cpu")
    checkpoint.restore_into(state, checkpoint.CheckpointManager(
        str(tmp_path / "ckpt")).restore(1), params_only=True)
    trainer_sr.decode_with_ema(config, QUIET, state)
    logits = step.make_logits_fn(step.make_apply_fn(state.model))(
        state, {"feats": feats, "inp_len": lengths})
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-5)


def test_decode_ema_without_an_ema_raises(weights, tmp_path):
    _, variables = weights
    _ema_checkpoint(variables, tmp_path, with_ema=False)
    config = _serve_config(tmp_path, "--tpu-decode-ema=True")
    with pytest.raises(ValueError, match="holds no EMA params"):
        Recognizer(config, device="cpu")
    state = TrainState.create(SequenceRouter(**MODEL), None, with_ema=True,
                              device="cpu")
    checkpoint.restore_into(state, checkpoint.CheckpointManager(
        str(tmp_path / "ckpt")).restore(1), params_only=True)
    with pytest.raises(ValueError, match="holds no EMA params"):
        trainer_sr.decode_with_ema(config, QUIET, state)
