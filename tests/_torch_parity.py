"""Helpers for the PyTorch-port parity tests: flax model variables
(SequenceRouter, the CNN, STF and LSTM encoders, ConvFrontEnd, attention
blocks) drawn from numpy at the shapes ``jax.eval_shape`` gives (no ``model.init``, which is slow on the
CPU), as plain nested dicts of numpy arrays; and the reference TF
checkpoint's variable names of such a tree (``reference_names``), with a
dict-backed checkpoint reader (``DictReader``)."""

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


# The reference TF checkpoint's variable names of a flax tree, for the
# import tool's tests (tests/test_torch_tools.py, test_torch_import_tf.py).
_SUF = "/.ATTRIBUTES/VARIABLE_VALUE"


def _convfe_names(names, attr, conv, stats, cnn_n=2):
    for layer in range(cnn_n):
        for branch in range(2):
            leaf = conv["conv%d_%d" % (layer, branch)]
            for part in ("kernel", "bias"):
                names["%s/conv_layers/%d/%d/%s" % (attr, branch, layer,
                                                   part)] = leaf[part]
        bn, st = conv["bn%d" % layer], stats["bn%d" % layer]
        for ref, value in (("gamma", bn["scale"]), ("beta", bn["bias"]),
                           ("moving_mean", st["mean"]),
                           ("moving_variance", st["var"])):
            names["%s/bn_layers/%d/%s" % (attr, layer, ref)] = value


def _dense_names(names, attr, tree):
    for part in ("kernel", "bias"):
        if part in tree:
            names["%s/%s" % (attr, part)] = tree[part]


def _ln_names(names, attr, tree):
    names[attr + "/gamma"] = tree["scale"]
    names[attr + "/beta"] = tree["bias"]


def _keras_lstm(names, base, cell):
    for part, side in (("kernel", "i"), ("recurrent_kernel", "h")):
        names[base + "/" + part] = np.concatenate(
            [cell[side + g]["kernel"] for g in "ifgo"], axis=1)
    names[base + "/bias"] = np.concatenate([cell["h" + g]["bias"]
                                            for g in "ifgo"])


def reference_names(family, variables, enc_num, flavor="naive"):
    """{reference variable name: array} of a flax tree, as the reference's
    object graph names them (the inverse of the import readers' mapping);
    SRF routing tensors in the flavor's broadcast layout."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    names = {}
    if family == "srf":
        _convfe_names(names, "conv", params["conv_feat"], stats["conv_feat"])
        _dense_names(names, "proj_pe", params["flatten"])
        _ln_names(names, "ln_i", params["ln_input"])
        _ln_names(names, "ln_o", params["ln_output"])
        for i in range(2):
            _dense_names(names, "ecs/%d" % i, params["encaps%d" % (i + 1)])
        for i in range(enc_num):
            _ln_names(names, "ln_m/%d" % i, params["ln_mid%d" % (i + 1)])
            wgt, bias = params["W%d" % i], params["b%d" % i]
            if flavor == "naive":  # [1, 1, ...] and [1, 1, ..., 1]
                wgt, bias = wgt[None, None], bias[None, None, ..., None]
            else:
                bias = bias[None]
            names["wgt/%d" % i], names["bias/%d" % i] = wgt, bias
    elif family == "stf":
        _convfe_names(names, "conv", params["conv"], stats["conv"])
        _dense_names(names, "linear_projection", params["linear_projection"])
        _ln_names(names, "layernorm", params["ln"])
        _dense_names(names, "proj", params["proj"])
        for i in range(enc_num):
            base, p = "enc_layers/%d" % i, params["enc%d" % i]
            _ln_names(names, base + "/layernorm_cur", p["ln_cur"])
            _ln_names(names, base + "/layernorm_res", p["ln_res"])
            for ref, ours in (("dense_layer_for_query", "wq"),
                              ("dense_layer_for_key", "wk"),
                              ("dense_layer_for_value", "wv"),
                              ("dense", "wo")):
                _dense_names(names, base + "/mha/" + ref, p["mha"][ours])
            _dense_names(names, base + "/ffn/ff_relu", p["ffn"]["ff1"])
            _dense_names(names, base + "/ffn/ff_proj", p["ffn"]["ff2"])
    elif family in ("lstm", "blstm"):
        if "conv_feat" in params:
            _convfe_names(names, "conv", params["conv_feat"],
                          stats["conv_feat"])
        for i in range(enc_num):
            base = "enc_layers/%d" % i
            if family == "blstm":
                _keras_lstm(names, base + "/forward_layer/cell",
                            params["lstm%d_f" % i])
                _keras_lstm(names, base + "/backward_layer/cell",
                            params["lstm%d_b" % i])
            else:
                _keras_lstm(names, base + "/cell", params["lstm%d_f" % i])
            _ln_names(names, "layernorms/%d" % i, params["ln%d" % i])
        _dense_names(names, "proj", params["proj"])
        _ln_names(names, "ln", params["ln_out"])
    else:  # cnn
        body = params["body"]
        if "conv_feat" in params:
            _convfe_names(names, "cnn_fe", params["conv_feat"],
                          stats["conv_feat"])
        for i in range(enc_num):
            _dense_names(names, "enc_layers/%d" % i, body["conv%d" % i])
            _ln_names(names, "layernorms/%d" % i, body["ln%d" % i])
        i = 0
        while "proj%d" % i in body:
            _dense_names(names, "proj/%d/layer" % i, body["proj%d" % i])
            _ln_names(names, "layernorms_proj/%d" % i, body["proj_ln%d" % i])
            i += 1
        _dense_names(names, "projv/layer", body["projv"])
        _ln_names(names, "layernorms_projv", body["projv_ln"])
    return names


class DictReader:
    """``tf.train.load_checkpoint``'s reader over a dict of arrays keyed by
    reference variable name (plus the optimizer entries a real checkpoint
    holds, which the readers skip)."""

    def __init__(self, names):
        self.values = {"model/%s%s" % (k, _SUF): np.asarray(v)
                       for k, v in names.items()}
        self.values["optimizer/iter" + _SUF] = np.asarray(7)
        self.values["save_counter" + _SUF] = np.asarray(1)

    def get_variable_to_shape_map(self):
        return {k: list(v.shape) for k, v in self.values.items()}

    def get_tensor(self, key):
        return self.values[key]
