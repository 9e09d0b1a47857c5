"""SpecAugment in the port (``srf_tpu_torch/ops/specaugment.py``) against
``srf_tpu/ops/specaugment.py``:

- the masking: JAX's draws, reproduced here with jax (the ``fold_in``
  calls of ``spec_augment``), given to the port's ``apply_masks`` give
  JAX's ``spec_augment`` output exactly;
- the port's own draws (its stream, F6), over many seeds and lengths,
  ``inp_len`` <= ``time_width``, ``inp_len`` 1 and F = 13: no mask reaches
  the padding, the widths respect both caps (0.2 x len and
  ``time_width``; F // 2 and ``freq_width``), and the padding is bit for
  bit unchanged;
- the train step augments in training mode only, and not without the
  flag.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops.specaugment import spec_augment as jax_spec_augment
from srf_tpu_torch.ops import specaugment
from srf_tpu_torch.train import step

torch.set_num_threads(1)


def _jax_draws(inp_len, feat_dim, rng, time_masks, time_width, freq_masks,
               freq_width):
    """The masks JAX's spec_augment draws from ``rng``, in the port's
    layout."""
    lens = jnp.asarray(inp_len, jnp.int32)
    batch = lens.shape[0]
    out = {"time_start": [], "time_width": [], "freq_start": [],
           "freq_width": []}
    for m in range(time_masks):
        r = jax.random.fold_in(rng, 2 * m)
        cap = jnp.minimum(time_width, (lens * 0.2).astype(jnp.int32))
        width = jax.random.randint(jax.random.fold_in(r, 0), (batch,), 0,
                                   1_000_000) % (cap + 1)
        start = jax.random.randint(jax.random.fold_in(r, 1), (batch,), 0,
                                   1_000_000) % jnp.maximum(
                                       lens - width + 1, 1)
        out["time_start"].append(np.asarray(start))
        out["time_width"].append(np.asarray(width))
    fcap = min(freq_width, max(feat_dim // 2, 1))
    for m in range(freq_masks):
        r = jax.random.fold_in(rng, 2 * m + 1)
        width = jax.random.randint(jax.random.fold_in(r, 0), (batch,), 0,
                                   fcap + 1)
        start = jax.random.randint(jax.random.fold_in(r, 1), (batch,), 0,
                                   1_000_000) % jnp.maximum(
                                       feat_dim - width + 1, 1)
        out["freq_start"].append(np.asarray(start))
        out["freq_width"].append(np.asarray(width))
    return {k: torch.as_tensor(np.stack(v) if v else np.zeros((0, batch)),
                               dtype=torch.long) for k, v in out.items()}


@pytest.mark.parametrize("seed,masks", [
    (0, (2, 40, 2, 15)), (1, (2, 40, 2, 15)), (2, (3, 10, 1, 27)),
    (3, (1, 5, 0, 15)), (4, (0, 40, 2, 4))])
def test_masking_equals_jax_with_its_draws(seed, masks):
    rng = np.random.RandomState(seed)
    feats = rng.randn(4, 120, 40).astype(np.float32)
    # padding non-zero, so that a mask reaching it would show
    inp_len = np.array([120, 77, 31, 5], np.int32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_spec_augment(
        jnp.asarray(feats), jnp.asarray(inp_len), key, *masks))
    draws = _jax_draws(inp_len, 40, key, *masks)
    got = specaugment.apply_masks(torch.from_numpy(feats),
                                  torch.from_numpy(inp_len), draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 0).any() or masks[0] + masks[2] == 0


@pytest.mark.parametrize("feat_dim", [13, 40, 123])
def test_own_draws_keep_the_caps_and_the_padding(feat_dim):
    rng = np.random.RandomState(feat_dim)
    batch, seq_len = 6, 90
    time_masks, time_width, freq_masks, freq_width = 2, 40, 2, 15
    for seed in range(40):
        inp_len = np.array([1, 2, 7, 40, 66, 90], np.int32)[
            rng.permutation(batch)]
        feats = torch.from_numpy(
            rng.randn(batch, seq_len, feat_dim).astype(np.float32) + 10.0)
        lens = torch.from_numpy(inp_len)
        generator = torch.Generator().manual_seed(seed)
        masks = specaugment.draw_masks(lens, feat_dim, generator, time_masks,
                                       time_width, freq_masks, freq_width)
        cap = np.minimum(time_width, (inp_len * 0.2).astype(np.int64))
        t_start, t_width = masks["time_start"].numpy(), \
            masks["time_width"].numpy()
        assert t_start.shape == (time_masks, batch)
        assert (t_width >= 0).all() and (t_width <= cap).all()
        assert (t_start >= 0).all() and (t_start + t_width <= inp_len).all()
        f_start, f_width = masks["freq_start"].numpy(), \
            masks["freq_width"].numpy()
        fcap = min(freq_width, max(feat_dim // 2, 1))
        assert (f_width >= 0).all() and (f_width <= fcap).all()
        assert (f_start >= 0).all() and (f_start + f_width <= feat_dim).all()
        out = specaugment.apply_masks(feats, lens, masks)
        for b, n in enumerate(inp_len):
            assert torch.equal(out[b, n:], feats[b, n:])  # the padding
            zero_rows = (out[b, :n] == 0).all(dim=1)
            # a time mask never empties an utterance: cap <= 0.2 x len
            assert int(zero_rows.sum()) <= time_masks * cap[b]
        # the same generator state gives the same masks
        again = specaugment.draw_masks(
            lens, feat_dim, torch.Generator().manual_seed(seed), time_masks,
            time_width, freq_masks, freq_width)
        assert all(torch.equal(masks[k], again[k]) for k in masks)


def _counting_model(seen):
    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, feats, lengths, generator=None):
            seen.append(feats.clone())
            return feats[:, ::4, :5] * self.w

    return Model()


def test_augmentation_in_training_mode_only():
    config = types.SimpleNamespace(
        tpu_specaug=True, tpu_specaug_time_masks=2,
        tpu_specaug_time_width=40, tpu_specaug_freq_masks=2,
        tpu_specaug_freq_width=15)
    seen = []
    feats = torch.ones(2, 200, 20)
    batch = {"feats": feats, "inp_len": torch.tensor([200, 150])}
    apply_fn = step.make_apply_fn(_counting_model(seen),
                                  augment_fn=specaugment.make_augment_fn(
                                      config))
    apply_fn(batch, False)
    assert torch.equal(seen[-1], feats)
    apply_fn(batch, True, torch.Generator().manual_seed(3))
    assert (seen[-1] == 0).any() and torch.equal(seen[-1][1, 150:],
                                                 feats[1, 150:])
    assert specaugment.make_augment_fn(
        types.SimpleNamespace(tpu_specaug=False)) is None
