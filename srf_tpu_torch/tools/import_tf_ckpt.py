"""CLI: import a REFERENCE TensorFlow checkpoint into a port checkpoint
(the port's counterpart of ``srf_tpu/tools/import_tf_ckpt.py``).

Migration path for users of the reference (sephiroce/srf): models trained
there (``tf.train.Checkpoint(optimizer=..., model=...)`` —
tfsr/helper/misc_helper.py:139-163) become a ``torch.save`` checkpoint
(``utils/checkpoint.py``) that the port's ``trainer_sr`` resumes from and
``serve`` loads, with the SAME flag set describing the architecture:

    python -m srf_tpu_torch.tools.import_tf_ckpt \
        --config=egs/conf/timit.conf --path-base=... \
        --path-vocab=timit_62.vocab [model flags] \
        --path-ckpt=checkpoint/imported \
        --tpu-import-src=/path/to/ref/ckpt-42 [--tpu-import-epoch=42]

``--tpu-import-src`` may be a checkpoint prefix (``.../ckpt-42``) or a
directory (the latest checkpoint is used). The mapping is name-based on
the checkpoint's object graph — no reference code is imported. The
variables are read with ``tf.train.load_checkpoint``; TensorFlow is
imported inside ``main`` only (a CPU tool: the card's machine has none).

The readers below are the JAX tool's (its ``read_*_params``, kept here as
the port's own copies): each yields the flax-layout numpy tree, which
``convert.flax_to_state_dict`` turns into the port's state_dict. Supported:
all four reference families — SRF (naive / lowmemory / einsum), STF,
(B)LSTM (with or without the CNN front end; Keras fused-LSTM kernels split
per gate), and both CNN variants. Optimizer slots are NOT imported
(fine-tuning restarts Adam's moments and the schedule's count); the epoch
is taken from the checkpoint name's ``ckpt-N`` unless
``--tpu-import-epoch`` overrides it.
"""

import os
import re
import sys

import numpy as np

from srf_tpu_torch.config import Logger, ParseOption

_SUF = "/.ATTRIBUTES/VARIABLE_VALUE"


def _squeeze_to(arr, ndim):
    """Drop broadcast 1-dims from the outside until ``ndim`` remains."""
    arr = np.asarray(arr)
    while arr.ndim > ndim and arr.shape[0] == 1:
        arr = arr[0]
    while arr.ndim > ndim and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim != ndim:
        raise ValueError("cannot normalize shape %s to %d dims"
                         % (arr.shape, ndim))
    return arr


def _reader(reader, hint):
    """Returns (names, get, _dense, _ln) over the checkpoint's model/ keys;
    ``get`` raises a KeyError naming the missing variable and ``hint``."""
    shape_map = reader.get_variable_to_shape_map()
    names = {
        k[len("model/"):-len(_SUF)]
        for k in shape_map
        if k.startswith("model/") and k.endswith(_SUF)
    }

    def get(name):
        if name not in names:
            raise KeyError(
                "reference checkpoint is missing 'model/%s' — not a %s "
                "checkpoint? (check --model-type; found: %s...)"
                % (name, hint, sorted(names)[:5])
            )
        return np.asarray(reader.get_tensor("model/" + name + _SUF))

    def _dense(attr):
        d = {"kernel": get(attr + "/kernel")}
        if attr + "/bias" in names:
            d["bias"] = get(attr + "/bias")
        return d

    def _ln(attr):
        return {"scale": get(attr + "/gamma"), "bias": get(attr + "/beta")}

    return names, get, _dense, _ln


def read_srf_params(reader):
    """Reference SRF checkpoint reader -> (params, batch_stats) pytrees."""
    names, get, _dense, _ln = _reader(reader, "reference SRF")

    enc_num = len({n for n in names if re.fullmatch(r"wgt/\d+", n)})
    cnn_n = len({
        m.group(1) for n in names
        if (m := re.fullmatch(r"conv/bn_layers/(\d+)/gamma", n))
    })
    if not enc_num or not cnn_n:
        raise KeyError(
            "no 'model/wgt/N' / 'model/conv/bn_layers/N' variables found — "
            "not a reference SRF checkpoint (for the other families pass "
            "the matching --model-type: stf, lstm/blstm, or cnn)"
        )

    conv_feat, conv_stats = _conv_frontend(get, names, "conv", cnn_n)

    params = {
        "conv_feat": conv_feat,
        "flatten": _dense("proj_pe"),
        "ln_input": _ln("ln_i"),
        "ln_output": _ln("ln_o"),
    }
    for i in range(2):
        params["encaps%d" % (i + 1)] = _dense("ecs/%d" % i)
    for i in range(enc_num):
        params["ln_mid%d" % (i + 1)] = _ln("ln_m/%d" % i)
        params["W%d" % i] = _squeeze_to(get("wgt/%d" % i), 4)
        params["b%d" % i] = _squeeze_to(get("bias/%d" % i), 3)
    return params, {"conv_feat": conv_stats}, enc_num


def _conv_frontend(get, names, attr, cnn_n=2):
    """Shared CNN front-end (reference CapsulationLayer): params + BN stats."""
    conv, stats = {}, {}
    for layer in range(cnn_n):
        for branch in range(2):
            conv["conv%d_%d" % (layer, branch)] = {
                "kernel": get("%s/conv_layers/%d/%d/kernel" % (attr, branch, layer)),
                "bias": get("%s/conv_layers/%d/%d/bias" % (attr, branch, layer)),
            }
        conv["bn%d" % layer] = {
            "scale": get("%s/bn_layers/%d/gamma" % (attr, layer)),
            "bias": get("%s/bn_layers/%d/beta" % (attr, layer)),
        }
        stats["bn%d" % layer] = {
            "mean": get("%s/bn_layers/%d/moving_mean" % (attr, layer)),
            "var": get("%s/bn_layers/%d/moving_variance" % (attr, layer)),
        }
    return conv, stats


def read_stf_params(reader):
    """Reference trainer_tf.ConvEncoder checkpoint -> (params, batch_stats).

    Attribute graph: model/enc_layers/N/{mha/dense_layer_for_*, ffn/
    {ff_relu, ff_proj}, layernorm_cur, layernorm_res}, model/layernorm,
    model/linear_projection, model/proj, model/conv/... (reference:
    tfsr/trainer_tf.py:39-118, tfsr/model/block.py:32-72,
    tfsr/model/attention.py:107-174). The mapping mirrors
    tests/tf_transplant.py transplant_stf.
    """
    names, get, _dense, _ln = _reader(reader, "reference STF (trainer_tf "
                                              "ConvEncoder)")
    num_layers = len({
        m.group(1) for n in names
        if (m := re.match(r"enc_layers/(\d+)/", n))
    })
    if not num_layers:
        raise KeyError("no 'model/enc_layers/N' variables found — not a "
                       "reference STF checkpoint")

    conv, conv_stats = _conv_frontend(get, names, "conv")
    params = {
        "conv": conv,
        "linear_projection": _dense("linear_projection"),
        "ln": _ln("layernorm"),
        "proj": _dense("proj"),
    }
    for i in range(num_layers):
        base = "enc_layers/%d" % i
        params["enc%d" % i] = {
            "ln_cur": _ln(base + "/layernorm_cur"),
            "ln_res": _ln(base + "/layernorm_res"),
            "mha": {
                "wq": _dense(base + "/mha/dense_layer_for_query"),
                "wk": _dense(base + "/mha/dense_layer_for_key"),
                "wv": _dense(base + "/mha/dense_layer_for_value"),
                "wo": _dense(base + "/mha/dense"),
            },
            "ffn": {
                "ff1": _dense(base + "/ffn/ff_relu"),
                "ff2": _dense(base + "/ffn/ff_proj"),
            },
        }
    return params, {"conv": conv_stats}, num_layers


def read_lstm_params(reader, bidirectional, units):
    """Reference LstmEncoder checkpoint -> (params, batch_stats).

    Keras fused-LSTM kernels are [in, 4*units] with gate order [i|f|c|o];
    flax OptimizedLSTMCell wants per-gate split input/hidden kernels with
    bias on the hidden ones (mapping mirrors tests/tf_transplant.py
    keras_lstm). Reference attrs: tfsr/model/lstm_encoder.py:31-103.
    """
    names, get, _dense, _ln = _reader(reader, "reference (B)LSTM")
    num_layers = len({
        m.group(1) for n in names
        if (m := re.match(r"enc_layers/(\d+)/", n))
    })
    if not num_layers:
        raise KeyError("no 'model/enc_layers/N' variables found")

    def _cell(base):
        kernel = get(base + "/kernel")
        recurrent = get(base + "/recurrent_kernel")
        bias = get(base + "/bias")
        out = {}
        for idx, gate in enumerate(["i", "f", "g", "o"]):
            sl = slice(idx * units, (idx + 1) * units)
            out["i" + gate] = {"kernel": kernel[:, sl]}
            out["h" + gate] = {"kernel": recurrent[:, sl],
                               "bias": bias[sl]}
        return out

    params, stats = {}, {}
    for i in range(num_layers):
        base = "enc_layers/%d" % i
        if bidirectional:
            params["lstm%d_f" % i] = _cell(base + "/forward_layer/cell")
            params["lstm%d_b" % i] = _cell(base + "/backward_layer/cell")
        else:
            params["lstm%d_f" % i] = _cell(base + "/cell")
        params["ln%d" % i] = {"scale": get("layernorms/%d/gamma" % i),
                              "bias": get("layernorms/%d/beta" % i)}
    params["proj"] = {"kernel": get("proj/kernel")}
    if "proj/bias" in names:
        params["proj"]["bias"] = get("proj/bias")
    params["ln_out"] = {"scale": get("ln/gamma"), "bias": get("ln/beta")}
    if any(n.startswith("conv/") for n in names):
        params["conv_feat"], stats = _conv_frontend(get, names, "conv")
        stats = {"conv_feat": stats}
    return params, stats, num_layers


def read_cnn_params(reader):
    """Reference CNNEncoder / CNNStrideEncoder checkpoint ->
    (params, batch_stats). Shared attrs: enc_layers/N (Conv2D),
    layernorms/N, proj/N/layer, projv/layer, layernorms_proj/N,
    layernorms_projv; the stride variant adds the cnn_fe front-end
    (reference: tfsr/model/cnn_stride_encoder.py:36-146,
    cnn_encoder.py:34-182)."""
    names, get, _dense, _ln = _reader(reader, "reference CNN")
    enc_num = len({
        m.group(1) for n in names
        if (m := re.match(r"enc_layers/(\d+)/kernel", n))
    })
    proj_layers = 1 + len({
        m.group(1) for n in names
        if (m := re.match(r"proj/(\d+)/layer/kernel", n))
    })
    if not enc_num:
        raise KeyError("no 'model/enc_layers/N' variables found")

    body = {}
    for i in range(enc_num):
        body["conv%d" % i] = _dense("enc_layers/%d" % i)
        body["ln%d" % i] = _ln("layernorms/%d" % i)
    for i in range(proj_layers - 1):
        body["proj%d" % i] = _dense("proj/%d/layer" % i)
        body["proj_ln%d" % i] = _ln("layernorms_proj/%d" % i)
    body["projv"] = _dense("projv/layer")
    body["projv_ln"] = _ln("layernorms_projv")

    params, stats = {"body": body}, {}
    if any(n.startswith("cnn_fe/") for n in names):
        params["conv_feat"], fe_stats = _conv_frontend(get, names, "cnn_fe")
        stats = {"conv_feat": fe_stats}
    return params, stats, enc_num


def _resolve_src(src):
    """Accept a checkpoint prefix or a directory containing checkpoints."""
    import tensorflow as tf

    if os.path.isdir(src):
        latest = tf.train.latest_checkpoint(src)
        if latest is None:
            raise FileNotFoundError("no TF checkpoint found under %s" % src)
        return latest
    return src


def read_params(reader, config):
    """(params, batch_stats, layer count, what a layer is called) of the
    reference checkpoint behind ``reader``, for ``config``'s model type."""
    model_type = (config.model_type or "srf").lower()
    if model_type == "stf":
        return (*read_stf_params(reader), "encoder blocks")
    if model_type in ("lstm", "blstm"):
        return (*read_lstm_params(reader,
                                  bidirectional=(model_type == "blstm"),
                                  units=config.model_dimension),
                "LSTM layers")
    if model_type in ("cnn", "conv", "convolution"):
        # same aliases the trainers accept (models/registry.py)
        return (*read_cnn_params(reader), "conv layers")
    return (*read_srf_params(reader), "capsule layers")


def imported_state_dict(model, params, batch_stats):
    """The port's state_dict of the flax tree ``params`` / ``batch_stats``,
    checked against ``model``'s: every entry present, of its shape, and
    no other (``SystemExit`` naming the first that is not)."""
    from srf_tpu_torch import convert

    state = convert.flax_to_state_dict(
        {"params": params, "batch_stats": batch_stats})
    for name, want in model.state_dict().items():
        if name not in state:
            raise SystemExit("imported tree is missing %s" % name)
        if tuple(state[name].shape) != tuple(want.shape):
            raise SystemExit(
                "shape mismatch at %s: checkpoint %s vs model %s — check "
                "the model-* flags describe the trained architecture"
                % (name, tuple(state[name].shape), tuple(want.shape))
            )
    extra = sorted(set(state) - set(model.state_dict()))
    if extra:
        raise SystemExit("imported tree has extra leaves: %s" % extra[:5])
    return state


def main(argv=None):
    os.environ.setdefault("TF_USE_LEGACY_KERAS", "1")
    os.environ.setdefault("TF_ENABLE_ONEDNN_OPTS", "0")
    logger = Logger(name="import_tf_ckpt", level=Logger.DEBUG).logger
    config = ParseOption(argv or sys.argv, logger).args
    if not config.tpu_import_src:
        raise SystemExit("--tpu-import-src is required")

    import tensorflow as tf

    from srf_tpu_torch.models.registry import build_model
    from srf_tpu_torch.train.optimizer import get_optimizer
    from srf_tpu_torch.train.state import TrainState
    from srf_tpu_torch.trainer_sr import state_to_tree
    from srf_tpu_torch.utils.checkpoint import CheckpointManager
    from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

    src = _resolve_src(config.tpu_import_src)
    logger.info("Importing reference checkpoint %s", src)
    params, batch_stats, ckpt_enc_num, kind = read_params(
        tf.train.load_checkpoint(src), config)

    _, _, dec_in_dim, _ = load_vocab(
        get_file_path(config.path_base, config.path_vocab), logger
    )
    model, _ = build_model(config, dec_in_dim + 1, logger)
    if config.model_encoder_num != ckpt_enc_num:
        raise SystemExit(
            "checkpoint has %d %s but --model-encoder-num=%d"
            % (ckpt_enc_num, kind, config.model_encoder_num)
        )
    state = imported_state_dict(model, params, batch_stats)
    model.load_state_dict(state)
    # a fresh optimizer and schedule, as JAX's template state has
    optimizer, scheduler = get_optimizer(config, model.parameters())
    train_state = TrainState.create(model, optimizer, scheduler,
                                    device="cpu")

    epoch = config.tpu_import_epoch
    if not epoch:
        m = re.search(r"ckpt-(\d+)$", src)
        epoch = int(m.group(1)) if m else 1
    manager = CheckpointManager(
        config.path_ckpt, max_to_keep=config.model_ckpt_max_to_keep
    )
    out = manager.save(epoch, state_to_tree(train_state))
    manager.close()
    logger.info(
        "Imported %d tensors -> %s (epoch %d; optimizer state fresh — "
        "resume with --path-ckpt-epoch=%d)", len(state), out, epoch, epoch,
    )


if __name__ == "__main__":
    main()
