"""The port's checkpoints (``torch.save``, one directory per step) and
their averaging against ``srf_tpu.utils.checkpoint`` (orbax): the same three
numpy-drawn flax trees of a small SRF, saved by each package (carried
across by convert.py), average to the same weights within 1e-7; plus the
manager's bookkeeping, ``load_checkpoint`` and the average_ckpt CLI."""

import os

import numpy as np
import pytest
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.utils import checkpoint as jax_checkpoint
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.tools import average_ckpt
from srf_tpu_torch.train.optimizer import get_optimizer
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils import checkpoint

from _torch_parity import random_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "egs", "data", "timit_62.vocab")
FLAGS = [
    "--feat-dim=8", "--model-encoder-num=3", "--model-caps-primary-num=4",
    "--model-caps-primary-dim=4", "--model-caps-convolution-num=3",
    "--model-caps-convolution-dim=4", "--model-caps-class-dim=4",
    "--model-caps-type=naive", "--model-caps-context=True",
    "--model-caps-iter=1", "--model-caps-window-lpad=1",
    "--model-caps-window-rpad=1", "--model-conv-filter-num=4",
]
LOGGER = Logger(name="test_torch_checkpoint", level=Logger.WARN).logger


def _argv(ckpt, *extra):
    return ["ckpt", "--path-base=%s" % REPO, "--path-vocab=%s" % VOCAB,
            "--path-ckpt=%s" % ckpt, *FLAGS, *extra]


def _config(ckpt, *extra):
    return ParseOption(_argv(ckpt, *extra), LOGGER, is_print_opts=False).args


def _trees():
    model = FlaxSequenceRouter(
        feat_dim=8, class_n=63, enc_num=3, caps_primary_num=4,
        caps_primary_dim=4, caps_conv_num=3, caps_conv_dim=4,
        caps_class_dim=4, caps_iter=1, lpad=1, rpad=1, is_context=True,
        conv_layer_num=2, conv_filter_num=4, caps_type="naive",
    )
    return [random_flax_variables(model, 8, seed=seed) for seed in (1, 2, 3)]


def _port_tree(variables, step):
    return {"step": step, "model": convert.flax_to_state_dict(variables),
            "optimizer": {"note": step}, "scheduler": None}


def _leaves(tree, prefix=""):
    for name, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + name + "/")
        else:
            yield prefix + name, np.asarray(value)


@pytest.fixture(scope="module")
def trees():
    return _trees()


def test_averaging_equals_jax(tmp_path, trees):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    template = {"step": np.zeros((), np.int32),
                "params": trees[0]["params"],
                "opt_state": {"count": np.zeros((), np.int32)},
                "batch_stats": trees[0]["batch_stats"]}
    manager = jax_checkpoint.CheckpointManager(str(jax_dir))
    port = checkpoint.CheckpointManager(str(port_dir))
    for step, tree in enumerate(trees, 1):
        manager.save(step, {"step": np.asarray(step, np.int32),
                            "params": tree["params"],
                            "opt_state": {"count": np.asarray(step, np.int32)},
                            "batch_stats": tree["batch_stats"]})
        port.save(step, _port_tree(tree, step))
    manager.close()
    want, want_steps = jax_checkpoint.average_checkpoints(
        str(jax_dir), template, 3)
    got, got_steps = checkpoint.average_checkpoints(str(port_dir), 3)
    assert want_steps == got_steps == [1, 2, 3]
    assert got["step"] == 3 and got["optimizer"] == {"note": 3}
    got_tree = convert.state_dict_to_flax(got["model"])
    want_leaves = dict(_leaves({"params": want["params"],
                                "batch_stats": want["batch_stats"]}))
    got_leaves = dict(_leaves(got_tree))
    assert want_leaves.keys() == got_leaves.keys()
    assert any(k.startswith("batch_stats/") for k in got_leaves)
    for key, value in want_leaves.items():
        assert got_leaves[key].dtype == np.float32
        np.testing.assert_allclose(got_leaves[key], value, rtol=0, atol=1e-7)
    # the max_epoch filter, as in JAX
    _, steps = checkpoint.average_checkpoints(str(port_dir), 3, max_epoch=2)
    assert steps == [1, 2]
    assert got["model"]["conv_feat.bn0.num_batches_tracked"].dtype == \
        torch.int64


def test_manager_keeps_steps_and_max_to_keep(tmp_path, trees):
    manager = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert manager.latest_step() is None and manager.all_steps() == []
    for step in (1, 2, 3):
        path = manager.save(step, _port_tree(trees[step - 1], step))
        assert path == os.path.join(str(tmp_path), str(step))
    assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
    assert manager.restore(2)["step"] == 2
    with pytest.raises(FileNotFoundError):
        manager.restore(1)
    keep_all = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=-1)
    keep_all.save(4, _port_tree(trees[0], 4))
    assert keep_all.all_steps() == [2, 3, 4]
    keep_all.purge()
    assert keep_all.all_steps() == []
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.average_checkpoints(str(tmp_path), 2)


def test_load_checkpoint_restores_latest_or_asked_step(tmp_path, trees):
    config = _config(tmp_path, "--train-lr-param-k=0.5",
                     "--train-warmup-n=1200")
    model, _ = build_model(config, 63)
    optimizer, scheduler = get_optimizer(config, model.parameters())
    state = TrainState(model=model, optimizer=optimizer,
                       scheduler=scheduler, device=torch.device("cpu"))
    manager, restored, step = checkpoint.load_checkpoint(
        config, LOGGER, state)
    assert restored is None and step == 0
    for i, tree in enumerate(trees, 1):
        manager.save(i, _port_tree(tree, i) | {
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict()})
    _, restored, step = checkpoint.load_checkpoint(config, LOGGER, state)
    assert restored is state and step == 3 and state.step == 3
    want = convert.flax_to_state_dict(trees[2])
    assert all(torch.equal(state.model.state_dict()[k], v)
               for k, v in want.items())
    config = _config(tmp_path, "--path-ckpt-epoch=2")
    bare = TrainState(model=model, optimizer=None)
    _, _, step = checkpoint.load_checkpoint(config, LOGGER, bare,
                                            params_only=True)
    want = convert.flax_to_state_dict(trees[1])
    assert step == 2 and all(torch.equal(model.state_dict()[k], v)
                             for k, v in want.items())
    # flags that do not describe the saved architecture fail loudly
    wide, _ = build_model(_config(tmp_path, "--model-caps-class-dim=5"), 63)
    with pytest.raises(RuntimeError, match="size mismatch"):
        checkpoint.load_checkpoint(config, LOGGER,
                                   TrainState(model=wide, optimizer=None),
                                   params_only=True)


def test_average_ckpt_cli(tmp_path, trees):
    manager = checkpoint.CheckpointManager(str(tmp_path))
    for step, tree in enumerate(trees, 1):
        manager.save(step, _port_tree(tree, step))
    average_ckpt.main(_argv(tmp_path, "--model-average-num=2"))
    avg = checkpoint.CheckpointManager(str(tmp_path / "avg"))
    assert avg.all_steps() == [1]
    saved = avg.restore(1)["model"]
    second, third = (convert.flax_to_state_dict(t) for t in trees[1:])
    for key, value in saved.items():
        if value.is_floating_point():
            want = ((second[key].double() + third[key].double()) / 2).float()
            assert torch.equal(value, want), key
    for bad in ("--model-average-num=0", "--model-average-num=-1"):
        with pytest.raises(SystemExit):
            average_ckpt.main(_argv(tmp_path, bad))
    # STF checkpoints average too (tests/test_torch_trainer_tf.py); flags
    # that describe another family than the checkpoints' fail the load
    with pytest.raises(RuntimeError, match="loading state_dict"):
        average_ckpt.main(_argv(tmp_path, "--model-average-num=2",
                                "--model-type=stf", "--model-dimension=8"))
    with pytest.raises(RuntimeError, match="size mismatch"):
        average_ckpt.main(_argv(tmp_path, "--model-average-num=2",
                                "--model-caps-class-dim=5"))
