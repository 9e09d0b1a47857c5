"""Helpers for the PyTorch-port parity tests: flax model variables
(SequenceRouter, the CNN, STF and LSTM encoders, ConvFrontEnd, attention
blocks) drawn from numpy at the shapes ``jax.eval_shape`` gives (no ``model.init``, which is slow on the
CPU), as plain nested dicts of numpy arrays."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

import srf_tpu.models.cnn as jax_cnn
from srf_tpu.models.cnn import CNNEncoder as FlaxCNNEncoder
from srf_tpu.models.cnn import CNNStrideEncoder as FlaxCNNStrideEncoder
from srf_tpu_torch.models.cnn import CNNEncoder, CNNStrideEncoder


def random_flax_variables(model, feat_dim=None, seed=0, init_args=None):
    """{"params"} and, where the model has BatchNorm, {"batch_stats"} for
    ``model`` (flax), drawn from numpy:
    kernels scaled by 1/sqrt(fan_in), routing W/b normal(0, 0.1), norm
    scales near 1, non-zero BatchNorm means and positive variances.
    ``init_args`` are ``model.init``'s arguments after the keys, by default
    an encoder's (feats [1, 8, feat_dim], lengths [1], False)."""
    key = jax.random.PRNGKey(0)
    if init_args is None:
        init_args = (jnp.zeros((1, 8, feat_dim), jnp.float32),
                     jnp.full((1,), 8, jnp.int32), False)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "dropout": key}, *init_args))
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if not hasattr(leaf, "shape"):
                out[name] = fill(leaf)
                continue
            shape = leaf.shape
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                value = rng.randn(*shape) / np.sqrt(fan_in)
            elif name == "scale":
                value = 1.0 + 0.1 * rng.randn(*shape)
            elif name == "var":
                value = rng.uniform(0.5, 1.5, size=shape)
            else:  # bias, mean, routing W{i} / b{i}
                value = 0.1 * rng.randn(*shape)
            out[name] = value.astype(np.float32)
        return out

    # a model without BatchNorm (the maxpool CNN) has no batch_stats
    return {name: fill(tree) for name, tree in shapes.items()
            if name in ("params", "batch_stats")}


def flatten_tree(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf} (the ``.npz`` key format)."""
    flat = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            flat.update(flatten_tree(value, prefix + name + "/"))
        else:
            flat[prefix + name] = value
    return flat


def cnn_pair(variant, **kwargs):
    """(flax model, port model) of one CNN variant ("maxpool" or "stride")
    with the same arguments."""
    if variant == "maxpool":
        return FlaxCNNEncoder(**kwargs), CNNEncoder(**kwargs)
    kwargs.setdefault("conv_filter_num", 4)
    return FlaxCNNStrideEncoder(**kwargs), CNNStrideEncoder(**kwargs)


def no_dropout(model):
    """Every port ``Dropout`` (both dropout kernels read its ``p``) at 0."""
    for module in model.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0
    return model


def patch_out_jax_dropout(monkeypatch):
    """flax's ``Dropout`` and the CNN's fused dropout as the identity."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    monkeypatch.setattr(jax_cnn, "fused_dropout", lambda x, seed, rate: x)
