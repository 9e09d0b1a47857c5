"""A reference TF checkpoint through the port's import CLI
(``python -m srf_tpu_torch.tools.import_tf_ckpt``), end to end.

The variables of a small SRF (the flax tree drawn from numpy) are written
under the reference's object-graph names (``model/wgt/0``,
``model/conv/conv_layers/1/0/kernel``, ...) by ``tf.train.Checkpoint``
over nested ``tf.Module``s, as the reference trainers' checkpoints name
them. The port's CLI imports it into a port checkpoint; restored into the
port's SRF, its logits must equal the flax model's on JAX's import of the
same checkpoint (``srf_tpu.tools.import_tf_ckpt.read_srf_params``) within
1e-5 (the float32 front ends differ in the order of their sums, ~3e-6).
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")
tf = pytest.importorskip("tensorflow")

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.tools.import_tf_ckpt import read_srf_params
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.tools import import_tf_ckpt
from srf_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_parity import random_flax_variables, reference_names

torch.set_num_threads(1)

FLAGS = [
    "--feat-dim=123", "--model-type=srf", "--model-caps-type=naive",
    "--model-caps-context=True", "--model-encoder-num=3",
    "--model-caps-primary-num=6", "--model-caps-primary-dim=4",
    "--model-caps-convolution-num=5", "--model-caps-convolution-dim=4",
    "--model-caps-class-dim=4", "--model-caps-iter=1",
    "--model-caps-window-lpad=1", "--model-caps-window-rpad=1",
    "--model-conv-filter-num=8", "--train-opti-type=adam",
    "--train-lr-param-k=0.001",
]


def _module_tree(names):
    """Nested tf.Modules (lists where a path part is an index) holding a
    tf.Variable at each name."""
    root = {}
    for name, value in names.items():
        node = root
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tf.Variable(value)

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        module = tf.Module()
        for key, value in node.items():
            setattr(module, key, build(value))
        return module

    return build(root)


def test_import_cli_round_trip_restores_jax_logits(tmp_path):
    flax_model = FlaxSequenceRouter(
        feat_dim=123, class_n=8, enc_num=3, caps_primary_num=6,
        caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
        caps_class_dim=4, caps_iter=1, lpad=1, rpad=1, is_context=True,
        conv_filter_num=8, caps_type="naive")
    variables = random_flax_variables(flax_model, 123, seed=3)
    model_module = _module_tree(reference_names("srf", variables, 3))
    prefix = tf.train.Checkpoint(model=model_module).save(
        str(tmp_path / "tf" / "ckpt"))
    assert prefix.endswith("ckpt-1")

    (tmp_path / "tiny.vocab").write_text(
        "".join(t + "\n" for t in ["<PADDING_SYMBOL>", "a", "b", "c", "d",
                                   "$", "@"]))
    argv = ["import_tf_ckpt", "--path-base=%s" % tmp_path,
            "--path-vocab=tiny.vocab", "--path-ckpt=%s" % (tmp_path / "out"),
            "--tpu-import-src=%s" % (tmp_path / "tf"),
            "--tpu-import-epoch=42", *FLAGS]
    import_tf_ckpt.main(argv)
    manager = CheckpointManager(str(tmp_path / "out"))
    assert manager.all_steps() == [42]
    tree = manager.restore(42)
    assert tree["optimizer"]["state"] == {}  # fresh optimizer

    logger = Logger(name="test_torch_import_tf", level=Logger.WARN).logger
    config = ParseOption(argv, logger, is_print_opts=False).args
    model, _ = build_model(config, 8)
    model.load_state_dict(tree["model"])
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 40, 123).astype(np.float32)
    lengths = np.array([40, 29])
    with torch.inference_mode():
        got = model.eval()(torch.tensor(feats), torch.tensor(lengths))

    params, batch_stats, _ = read_srf_params(
        tf.train.load_checkpoint(str(tmp_path / "tf")))
    want = flax_model.apply({"params": params, "batch_stats": batch_stats},
                            feats, lengths, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
