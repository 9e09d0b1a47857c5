"""The port's SequenceRouter against the flax one, eval mode, same weights
carried across by srf_tpu_torch.convert.

Small width (L=3, PH=12, PD=4, CH=6, CD=4, VD=4, 8 filters) at the real
feature width 123 and 63 classes. T=40 and T=37 hit both parities of flax's
SAME padding on the time axis (123 and 62 do on the frequency axis). Logit
tolerance atol 3e-5: flax's LayerNorm takes the variance as E[x^2]-E[x]^2
and torch as E[(x-E[x])^2], and convolution/contraction sums run in another
order; those float32 differences pass through the front end, the routing
stack and five LayerNorms. They measure ~3e-6 on logits of magnitude ~3;
a front-end or padding fault moves logits by O(1). Two of the three
utterances are shorter than the padded batch, so the padded frames that the
routing windows read (non-zero after the first capsule layer, as in JAX)
are part of the comparison.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu_torch import convert
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.train import step
from srf_tpu_torch.train.state import TrainState

from _torch_parity import flatten_tree, random_flax_variables

torch.set_num_threads(1)

FEAT_DIM, CLASS_N = 123, 63


def _models(caps_type, is_context, caps_iter):
    kwargs = dict(
        feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=3, caps_primary_num=12,
        caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4,
        caps_class_dim=4, caps_iter=caps_iter, lpad=1, rpad=1,
        is_context=is_context, conv_layer_num=2, conv_filter_num=8,
        caps_type=caps_type,
    )
    return FlaxSequenceRouter(**kwargs), SequenceRouter(**kwargs)


def test_convert_round_trip(tmp_path):
    flax_model, model = _models("naive", True, 1)
    variables = random_flax_variables(flax_model, FEAT_DIM)
    state = convert.flax_to_state_dict(variables)
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state)  # strict: names and shapes agree
    back = convert.state_dict_to_flax(model.state_dict())
    want, got = flatten_tree(variables), flatten_tree(back)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the same tree as a '/'-keyed npz, as exported from the JAX side
    path = tmp_path / "weights.npz"
    np.savez(path, **flatten_tree(variables))
    loaded = convert.load_npz(str(path))
    assert sorted(loaded) == sorted(state)
    for key in state:
        assert torch.equal(loaded[key], state[key]), key


@pytest.mark.parametrize("caps_type,is_context,caps_iter,seq_len", [
    ("naive", True, 1, 40),
    ("naive", True, 1, 37),
    ("einsum", True, 2, 40),
    ("naive", False, 2, 37),
])
def test_logits_match_flax(caps_type, is_context, caps_iter, seq_len):
    flax_model, model = _models(caps_type, is_context, caps_iter)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=seq_len)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    model.eval()
    rng = np.random.RandomState(7)
    feats = rng.randn(3, seq_len, FEAT_DIM).astype(np.float32)
    lengths = np.array([seq_len, seq_len - 7, 13], np.int32)
    want = jax.jit(lambda v, f, l: flax_model.apply(v, f, l, False))(
        variables, jnp.asarray(feats), jnp.asarray(lengths))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(lengths))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)


@pytest.mark.parametrize("init_name", ["fan_avg", "uniform", None])
def test_initial_weights(init_name):
    def build(seed):
        generator = torch.Generator().manual_seed(seed)
        return SequenceRouter(
            feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=3,
            caps_primary_num=12, caps_primary_dim=4, caps_conv_num=6,
            caps_conv_dim=4, caps_class_dim=4, caps_iter=1, lpad=1, rpad=1,
            is_context=True, conv_filter_num=8, init_name=init_name,
            generator=generator).state_dict()

    state, again, other = build(0), build(0), build(1)
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert not torch.equal(state["W0"], other["W0"])
    kernel = state["flatten.weight"]  # Linear [out=12, in=31*8]
    fan_in, fan_out = kernel.shape[1], kernel.shape[0]
    limit = 0.05 if init_name == "uniform" else (6 / (fan_in + fan_out)) ** 0.5
    assert kernel.abs().max() <= limit and kernel.abs().max() > 0.8 * limit
    assert not state["conv_feat.conv0_0.bias"].any()
    routing = torch.cat([state["W0"].flatten(), state["b0"].flatten()])
    assert abs(routing.std().item() - 0.1) < 0.01
    assert torch.equal(state["ln_input.weight"],
                       torch.ones_like(state["ln_input.weight"]))


def test_training_mode_runs():
    """test_torch_train.py holds training mode to flax."""
    _, model = _models("naive", True, 1)
    logits = model.train()(torch.zeros(1, 8, FEAT_DIM), torch.tensor([8]))
    assert logits.shape == (1, 2, CLASS_N) and logits.requires_grad


def test_training_mode_is_refused():
    """What training refused before the training extras were ported is
    accepted now: bf16 and SpecAugment in the apply adapter, gradient
    accumulation and EMA in the train step and its state (each held to
    JAX in tests/test_torch_{bf16,specaugment,train_extras}.py)."""
    _, model = _models("naive", True, 1)
    feats, lengths = torch.randn(2, 8, FEAT_DIM), torch.tensor([8, 6])
    for kwargs in ({"bf16": True}, {"augment_fn": lambda f, l, g: f * 0}):
        logits = step.make_apply_fn(model, **kwargs)(
            {"feats": feats, "inp_len": lengths}, True)
        assert logits.dtype == torch.float32 and logits.shape == (2, 2,
                                                                  CLASS_N)
    apply_fn = step.make_apply_fn(model)
    for kwargs in ({"accum_steps": 2}, {"ema_decay": 0.999}):
        assert callable(step.make_train_step(apply_fn, 4, **kwargs))
    state = TrainState.create(model, None, with_ema=True, device="cpu")
    assert set(state.ema) == {n for n, _ in model.named_parameters()}
