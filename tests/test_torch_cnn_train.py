"""The port's train step on the maxout CNN against srf_tpu's, from the same
numpy weights, with dropout off on both sides (flax's ``Dropout.__call__``
and ``srf_tpu.models.cnn.fused_dropout`` patched to the identity, the
port's rates set to 0; the 0.2 after each conv and projection is fixed in
both models, so no flag turns it off).

3 steps of ``make_train_step`` against ``srf_tpu.train.step
.make_train_step(..., mesh=None, donate=False)``, Adam under Noam(k=0.05,
d=1, warmup 4) with timit.conf's betas and eps, both variants (the maxpool
one at the recipe's time stride 1, the stride one behind ``ConvFrontEnd``
and its BatchNorm), B=2, T=24, with the tolerances of
``test_torch_train.py``: ``loss_sum`` each step within rtol 1e-5; every
gradient of step 1 within 1e-4 of its largest entry; parameters after
step 3 within atol 5e-5 and BatchNorm statistics within 1e-5. The models
are at filters 16, projections of 32 (``test_torch_cnn.py`` says why a
LayerNorm over fewer channels makes float32 parity chaotic).

Also the port's ``pallas``-mode step with dropout on, on the CPU (K5's
plain version): the same step seed gives the same loss, another seed
another.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops.ctc import ctc_loss_from_frames as jax_ctc_loss_from_frames
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.ops.dropout_cuda import fused_dropout_cuda
from srf_tpu_torch.train import optimizer, step
from srf_tpu_torch.train.state import TrainState

from _torch_parity import (cnn_pair, flatten_tree, no_dropout,
                           patch_out_jax_dropout, random_flax_variables)

torch.set_num_threads(1)

FEAT_DIM, CLASS_N = 12, 7
# every LayerNorm over >= 7 channels (test_torch_cnn.py)
WIDE = dict(enc_num=6, feat_dim=FEAT_DIM, nfilt_inp=16, nfilt_inn=16,
            proj_layers=3, proj_dim=32)
CONFIG = types.SimpleNamespace(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=1,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)
VARIANTS = {  # variant -> (model arguments, in_len_div)
    "maxpool": (dict(WIDE, class_n=CLASS_N, stride=1), 1),
    "stride": (dict(WIDE, class_n=CLASS_N), 4),
}


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


@pytest.mark.parametrize("variant,dropout_impl", [("maxpool", "pallas"),
                                                  ("stride", "pallas"),
                                                  ("stride", "xla")])
def test_train_step_matches_jax(variant, dropout_impl, monkeypatch):
    patch_out_jax_dropout(monkeypatch)
    kwargs, in_len_div = VARIANTS[variant]
    kwargs = dict(kwargs, dropout_impl=dropout_impl)
    flax_model, model = cnn_pair(variant, **kwargs)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=3)
    batch = _batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    tx, _ = jax_optimizer.get_optimizer(CONFIG)
    jax_apply = jax_step.make_apply_fn(flax_model)
    params = jax.tree.map(jnp.asarray, variables["params"])
    batch_stats = jax.tree.map(jnp.asarray, variables.get("batch_stats", {}))

    def loss_fn(p):
        logits, _ = jax_apply(p, batch_stats, jax_batch, True,
                              jax.random.PRNGKey(0))
        pe = jax_ctc_loss_from_frames(logits, jax_batch["inp_len"],
                                      in_len_div, jax_batch["labels"],
                                      jax_batch["tar_len"])
        return jnp.sum(pe) / len(batch["inp_len"])

    jax_grads = jax.jit(jax.grad(loss_fn))(params)
    jax_state = JaxTrainState.create(params, tx, batch_stats)
    jax_train = jax_step.make_train_step(jax_apply, tx, in_len_div,
                                         mesh=None, donate=False)

    model = no_dropout(model)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
    state = TrainState.create(model, opt, scheduler, device="cpu")
    train_step = step.make_train_step(step.make_apply_fn(model), in_len_div)

    for i in range(3):
        jax_state, jax_metrics = jax_train(jax_state, jax_batch,
                                           jax.random.PRNGKey(i))
        state, metrics = train_step(state, torch_batch, 1234)
        np.testing.assert_allclose(metrics["loss_sum"].item(),
                                   float(jax_metrics["loss_sum"]), rtol=1e-5)
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


@pytest.mark.parametrize("variant", ["maxpool", "stride"])
def test_pallas_dropout_follows_the_step_seed(variant):
    """On the CPU the K5 sites run the plain version (the kernel never
    launches); masks come from the step's seed and each site's ordinal."""
    kwargs, in_len_div = VARIANTS[variant]
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=6).items()}
    weights = cnn_pair(variant, **kwargs)[1].state_dict()

    def first_loss(seed):
        model = cnn_pair(variant, **dict(kwargs, dropout_impl="pallas"))[1]
        model.load_state_dict(weights)
        if variant == "stride":  # its front end draws from the generator
            model.conv_feat.dropout.p = 0.0
        opt, scheduler = optimizer.get_optimizer(CONFIG, model.parameters())
        state = TrainState.create(model, opt, scheduler, device="cpu")
        train_step = step.make_train_step(step.make_apply_fn(model),
                                          in_len_div)
        return train_step(state, batch, seed)[1]["loss_sum"].item()

    launches = fused_dropout_cuda.launches
    assert first_loss(1234) == first_loss(1234)
    assert first_loss(1234) != first_loss(99)
    assert fused_dropout_cuda.launches == launches
