"""Helpers for the PyTorch-port parity tests: flax SequenceRouter variables
drawn from numpy at the shapes ``jax.eval_shape`` gives (no ``model.init``,
which is slow on the CPU), as plain nested dicts of numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np


def random_flax_variables(model, feat_dim, seed=0):
    """{"params", "batch_stats"} for ``model`` (flax), drawn from numpy:
    kernels scaled by 1/sqrt(fan_in), routing W/b normal(0, 0.1), norm
    scales near 1, non-zero BatchNorm means and positive variances."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "dropout": key},
                           jnp.zeros((1, 8, feat_dim), jnp.float32),
                           jnp.full((1,), 8, jnp.int32), False)
    )
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

    return {"params": fill(shapes["params"]),
            "batch_stats": fill(shapes["batch_stats"])}


def flatten_tree(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf} (the ``.npz`` key format)."""
    flat = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            flat.update(flatten_tree(value, prefix + name + "/"))
        else:
            flat[prefix + name] = value
    return flat
