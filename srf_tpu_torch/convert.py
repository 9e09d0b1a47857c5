"""Weights carried across between the JAX package and the port.

The flax side is the variable tree as nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}`` (``batch_stats`` only where the
model has BatchNorm), with the names fixed by ``srf_tpu/models/srf.py``,
``cnn.py`` and ``layers.py`` (``conv_feat/conv{i}_{b}``,
``conv_feat/bn{i}``, ``flatten``, ``encaps1/2``, ``ln_input``, ``W{i}``/
``b{i}``, ``ln_mid{i}``, ``ln_output``; ``body/conv{i}``, ``body/ln{i}``,
``body/proj{i}``, ``body/proj_ln{i}``, ``body/projv``, ``body/projv_ln``).
The port side is the model's ``state_dict``. Layouts change on the way:

- Dense kernel [in, out]        <-> Linear weight [out, in]
- Conv kernel HWIO              <-> Conv2d weight OIHW
- a kernel without a bias (the CNN's ``use_bias=False``) <-> a module
  without one
- LayerNorm / BatchNorm scale   <-> weight; BatchNorm mean/var (from
  ``batch_stats``) <-> running_mean/running_var
- routing W{i} [in_n, out_n, out_d, in_d] and b{i} keep their layout.
- an LSTM cell ``lstm{i}_f`` (``lstm{i}_b``, the backward direction) of
  flax's per-gate kernels ``ii/if/ig/io`` [in, H] and ``hi/hf/hg/ho``
  [H, H] with biases <-> ``lstm{i}.weight_ih_l0`` [4H, in],
  ``weight_hh_l0`` [4H, H] and ``bias_hh_l0`` [4H] (``_l0_reverse`` for
  the backward direction), gates stacked in torch's i, f, g, o order;
  torch's second bias ``bias_ih_l0`` is zero (``models/lstm.py``): it is
  written as zeros, and refused on the way back unless it is.

The STF's attention (``wq``/``wk``/``wv``/``wo``), feed-forward and
projections are ordinary Dense layers.

``load_npz`` reads a ``.npz`` whose keys are the tree's paths joined by
``/`` (``params/conv_feat/conv0_0/kernel``), so weights exported from the
JAX side load without JAX.

JAX's EMA of the parameters (``ema_params``, a params tree without
BatchNorm statistics) becomes the port's ``TrainState.ema``, keyed as
``named_parameters`` (the LSTM's frozen zero ``bias_ih`` is not in it):
:func:`ema_from_flax` and :func:`ema_to_flax`.
"""

import numpy as np
import torch

from srf_tpu_torch.train.state import NO_EMA


def _tensor(array):
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))


def flax_to_state_dict(variables):
    """flax variable tree (numpy leaves) -> the port's state_dict."""
    state = {}
    _params_to_state(variables["params"], variables.get("batch_stats", {}),
                     "", state)
    return state


_GATES = "ifgo"  # torch's gate order, flax's gate names


def _cell_to_state(cell, key, state):
    """One flax LSTM cell ``{prefix}lstm{i}_f`` / ``_b`` -> nn.LSTM keys."""
    suffix = "_l0_reverse" if key.endswith("_b") else "_l0"
    module = key[:-2]
    for kind, side in (("weight_ih", "i"), ("weight_hh", "h")):
        state[module + "." + kind + suffix] = _tensor(np.concatenate(
            [np.asarray(cell[side + g]["kernel"]).T for g in _GATES]))
    bias = np.concatenate([np.asarray(cell["h" + g]["bias"]) for g in _GATES])
    state[module + ".bias_ih" + suffix] = _tensor(np.zeros_like(bias))
    state[module + ".bias_hh" + suffix] = _tensor(bias)


def _cell_from_state(params, path, leaf, array):
    """One nn.LSTM tensor ``weight_ih_l0[_reverse]`` etc. -> the flax cell."""
    kind, _ = leaf.split("_l0")
    cell = _subtree(params, path[:-1] + [
        path[-1] + ("_b" if leaf.endswith("_reverse") else "_f")])
    if kind == "bias_ih":
        if np.any(array):
            raise ValueError("%s: flax's LSTM cell has one bias; bias_ih "
                             "must be zero" % ".".join(path + [leaf]))
        return
    for g, block in zip(_GATES, np.split(array, len(_GATES), axis=0)):
        if kind == "bias_hh":
            cell.setdefault("h" + g, {})["bias"] = block
        else:
            name = ("i" if kind == "weight_ih" else "h") + g
            cell.setdefault(name, {})["kernel"] = np.ascontiguousarray(block.T)


def _params_to_state(params, stats, prefix, state):
    for name, value in params.items():
        key = prefix + name
        if isinstance(value, dict) and "ii" in value:
            _cell_to_state(value, key, state)
        elif not isinstance(value, dict):
            state[key] = _tensor(value)  # routing W{i} / b{i}
        elif "kernel" in value:
            kernel = np.asarray(value["kernel"])
            if kernel.ndim == 4:
                weight = np.transpose(kernel, (3, 2, 0, 1))  # HWIO -> OIHW
            elif kernel.ndim == 2:
                weight = kernel.T  # [in, out] -> [out, in]
            else:
                raise ValueError("unexpected kernel %s of shape %s"
                                 % (key, kernel.shape))
            state[key + ".weight"] = _tensor(weight)
            if "bias" in value:  # the CNN's convs and Dense have none
                state[key + ".bias"] = _tensor(value["bias"])
        elif "scale" in value:
            state[key + ".weight"] = _tensor(value["scale"])
            state[key + ".bias"] = _tensor(value["bias"])
            if name in stats:  # BatchNorm
                state[key + ".running_mean"] = _tensor(stats[name]["mean"])
                state[key + ".running_var"] = _tensor(stats[name]["var"])
                state[key + ".num_batches_tracked"] = torch.tensor(0)
        else:
            _params_to_state(value, stats.get(name, {}), key + ".", state)


def state_dict_to_flax(state):
    """The port's state_dict -> flax variable tree (numpy leaves); the
    inverse of :func:`flax_to_state_dict`."""
    params, stats = {}, {}
    for key, tensor in state.items():
        *path, leaf = key.split(".")
        array = tensor.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            node = _subtree(stats, path)
            node["mean" if leaf == "running_mean" else "var"] = array
            continue
        if not path:  # routing W{i} / b{i}
            params[leaf] = array
            continue
        if "_l0" in leaf:  # an nn.LSTM
            _cell_from_state(params, path, leaf, array)
            continue
        node = _subtree(params, path)
        if leaf == "bias":
            node["bias"] = array
        elif array.ndim == 1:
            node["scale"] = array
        elif array.ndim == 2:
            node["kernel"] = np.ascontiguousarray(array.T)
        else:
            node["kernel"] = np.ascontiguousarray(
                np.transpose(array, (2, 3, 1, 0)))  # OIHW -> HWIO
    # a model without BatchNorm (the maxpool CNN) has no batch_stats
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def ema_from_flax(ema_params):
    """JAX's ``ema_params`` tree (numpy leaves) -> the port's EMA dict of
    the trained parameters, keyed as ``named_parameters``."""
    state = flax_to_state_dict({"params": ema_params})
    return {k: v for k, v in state.items() if ".bias_ih_l0" not in k}


def ema_to_flax(ema):
    """The port's EMA dict -> JAX's ``ema_params`` tree (numpy leaves)."""
    return state_dict_to_flax(ema)["params"]


def _subtree(tree, path):
    for name in path:
        tree = tree.setdefault(name, {})
    return tree


def load_npz(path, ema=False):
    """A ``.npz`` of the flax tree with ``/``-joined keys -> state_dict;
    ``ema``: the parameters from its ``ema_params`` subtree (with its
    ``batch_stats``), as ``--tpu-decode-ema`` serves them."""
    variables = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            _subtree(variables, parents)[leaf] = flat[key]
    if ema:
        if "ema_params" not in variables:
            raise ValueError(NO_EMA)
        variables["params"] = variables["ema_params"]
    return flax_to_state_dict(variables)
