"""The wavefront SDR stack (``--tpu-routing-kernel=wavefront``) of the port
against ``srf_tpu.ops.routing.wavefront_sdr_stack`` and the flax model's
wavefront branch, on the same numpy inputs and weights.

Tolerances are JAX's own for its wavefront against its layered path
(``tests/test_models.py``): outputs and logits within atol 2e-5, each
gradient within 2e-4 + 1e-3 x its largest entry. Both sides run float32 and
the same routing math; they differ in the order of sums (the factored
contractions, the LayerNorms) and measure ~1e-6 on outputs of magnitude ~2.

Dropout draws differ between the packages (F21: JAX folds a key per layer
and step, the port draws its masks before the loop), so the parity checks
run without it; with it, ``remat`` must not change a bit of the outputs or
the gradients (the recompute sees the masks the forward drew), and the
masks keep 1 - rate of the entries.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops.routing import wavefront_sdr_stack as jax_wavefront
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models import registry
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.ops.routing import wavefront_sdr_stack

from _torch_parity import flatten_tree, random_flax_variables

torch.set_num_threads(1)

GEOMETRIES = [(1, 1, 1), (3, 2, 1), (1, 1, 0), (1, 0, 0)]
OUT_ATOL = 2e-5


def grad_atol(want):
    return 2e-4 + 1e-3 * float(np.max(np.abs(want)))


def _stack_inputs(rng, n_layers, lpad, rpad, batch=2, seq_len=7):
    """u [B, T, 3, 4]; per layer (W, b) and LayerNorm (scale, bias): hidden
    layers of 3 capsules of 4, a class layer of 5 capsules of 3."""
    window = lpad + rpad + 1
    u = rng.randn(batch, seq_len, 3, 4).astype(np.float32)
    layers, norms = [], []
    prev_n, prev_d = 3, 4
    for i in range(n_layers):
        out_n, out_d = (5, 3) if i == n_layers - 1 else (3, 4)
        shape = (window * prev_n, out_n, out_d, prev_d)
        layers.append((0.3 * rng.randn(*shape).astype(np.float32),
                       0.1 * rng.randn(*shape[:3]).astype(np.float32)))
        norms.append(((1 + 0.1 * rng.randn(out_n * out_d)).astype(np.float32),
                      0.1 * rng.randn(out_n * out_d).astype(np.float32)))
        prev_n, prev_d = out_n, out_d
    return u, layers, norms


def _leaves(u, layers, norms):
    return [torch.tensor(u, requires_grad=True),
            [tuple(torch.tensor(x, requires_grad=True) for x in pair)
             for pair in layers],
            [tuple(torch.tensor(x, requires_grad=True) for x in pair)
             for pair in norms]]


def _flat_grads(u, layers, norms):
    return [u.grad.numpy()] + [x.grad.numpy() for pairs in (layers, norms)
                               for pair in pairs for x in pair]


@pytest.mark.parametrize("n_layers", [1, 2, 4])
@pytest.mark.parametrize("caps_iter,lpad,rpad", GEOMETRIES)
def test_stack_matches_jax(caps_iter, lpad, rpad, n_layers):
    u, layers, norms = _stack_inputs(
        np.random.RandomState(10 * n_layers + caps_iter), n_layers, lpad,
        rpad)

    def loss(u, layers, norms):
        out = jax_wavefront(u, layers, lpad, rpad, caps_iter, norms)
        return jnp.sum(out * out), out

    (_, want), jax_grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(u, layers, norms)
    leaves = _leaves(u, layers, norms)
    out = wavefront_sdr_stack(*leaves[:2], lpad, rpad, caps_iter, leaves[2])
    assert out.shape == (2, 7, 5, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)
    (out * out).sum().backward()
    for got, want in zip(_flat_grads(*leaves),
                         jax.tree.leaves(jax_grads)):
        np.testing.assert_allclose(got, np.asarray(want),
                                   atol=grad_atol(want), rtol=0)


def test_one_layer_routes_through_the_sdr_function(monkeypatch):
    """With one layer the stack is that layer's SDR through ``SDRFunction``
    (K1 and K2 on a CUDA tensor, the plain loop here), not a plain loop of
    its own that would bypass the kernels on the card."""
    from srf_tpu_torch.ops import routing

    calls, real = [], routing.SDRFunction

    class Spy:
        @staticmethod
        def apply(*args):
            calls.append(args[3:])
            return real.apply(*args)

    monkeypatch.setattr(routing, "SDRFunction", Spy)
    u, layers, norms = _stack_inputs(np.random.RandomState(3), 1, 1, 1)
    leaves = _leaves(u, layers, norms)
    wavefront_sdr_stack(*leaves[:2], 1, 1, 2, leaves[2])
    assert calls == [(2, True, False)]


@pytest.mark.parametrize("n_layers", [1, 4])
def test_remat_replays_the_dropout_masks(n_layers):
    """With dropout on and one generator seed, remat on and off give the
    same outputs and gradients to the bit: the masks are drawn before the
    loop, so the checkpoint's recompute (which replays only the default
    generators' state) routes the same frames."""
    u, layers, norms = _stack_inputs(np.random.RandomState(5), n_layers,
                                     1, 1)
    results = []
    for remat in (True, False):
        leaves = _leaves(u, layers, norms)
        out = wavefront_sdr_stack(
            *leaves[:2], 1, 1, 1, leaves[2], dropout_rate=0.3,
            generator=torch.Generator().manual_seed(7), remat=remat)
        (out * out).sum().backward()
        results.append([out.detach().numpy()] + _flat_grads(*leaves))
    assert (results[0][0] == 0).any()
    for got, want in zip(*results):
        np.testing.assert_array_equal(got, want)


def test_keep_rate():
    """Over ~50k output entries the share kept (non-zero: a LayerNorm's
    output is never exactly zero) is within 3 sigma of 1 - rate."""
    rate = 0.2
    u, layers, norms = _stack_inputs(np.random.RandomState(6), 2, 1, 1,
                                     batch=64, seq_len=50)
    with torch.no_grad():
        out = wavefront_sdr_stack(
            torch.tensor(u), [tuple(map(torch.tensor, p)) for p in layers],
            1, 1, 1, [tuple(map(torch.tensor, p)) for p in norms],
            dropout_rate=rate, generator=torch.Generator().manual_seed(3))
    kept = float((out != 0).float().mean())
    sigma = np.sqrt(rate * (1 - rate) / out.numel())
    assert abs(kept - (1 - rate)) <= 3 * sigma


MODEL_KW = dict(feat_dim=123, class_n=63, enc_num=4, caps_primary_num=6,
                caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
                caps_class_dim=4, is_context=True, conv_filter_num=8,
                caps_type="naive")


def _feats():
    rng = np.random.RandomState(4)
    return rng.randn(2, 40, 123).astype(np.float32), np.array([40, 33])


def _port_grads(model, feats, lengths):
    model.zero_grad()
    out = model(torch.tensor(feats), torch.tensor(lengths))
    (out * out).sum().backward()
    grads = convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()})["params"]
    return out.detach().numpy(), flatten_tree(grads)


@pytest.mark.parametrize("caps_iter,lpad,rpad", GEOMETRIES)
def test_model_matches_jax_and_the_layered_path(caps_iter, lpad, rpad):
    """The port's wavefront SequenceRouter against JAX's wavefront and
    against the port's layered model, on the same carried weights (JAX's
    test geometry, eval mode): logits and every parameter's gradient of
    sum(logits^2)."""
    kw = dict(MODEL_KW, caps_iter=caps_iter, lpad=lpad, rpad=rpad)
    flax_model = FlaxSequenceRouter(**kw, routing_impl="wavefront")
    variables = random_flax_variables(flax_model, 123)
    feats, lengths = _feats()

    def loss(params):
        out = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            feats, lengths, False)
        return jnp.sum(out * out), out

    (_, want), jax_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    jax_grads = flatten_tree(jax.tree.map(np.asarray, jax_grads))
    state = convert.flax_to_state_dict(variables)
    results = {}
    for impl in ("wavefront", "auto"):
        model = SequenceRouter(**kw, routing_impl=impl)
        model.load_state_dict(state)
        results[impl] = _port_grads(model.eval(), feats, lengths)
    for impl, (logits, grads) in results.items():
        np.testing.assert_allclose(logits, np.asarray(want), atol=OUT_ATOL,
                                   rtol=0, err_msg=impl)
        assert sorted(grads) == sorted(jax_grads)
        for key, ref in jax_grads.items():
            np.testing.assert_allclose(grads[key], ref, atol=grad_atol(ref),
                                       rtol=0, err_msg="%s %s" % (impl, key))


def test_model_training_mode_dropout_and_remat():
    """In training mode the wavefront draws the inner dropout from the
    forward's generator: remat on and off give the same logits and
    gradients from one seed, and dropout moves the logits."""
    model = SequenceRouter(**MODEL_KW, caps_iter=1, lpad=1, rpad=1,
                           routing_impl="wavefront",
                           generator=torch.Generator().manual_seed(0))
    feats, lengths = _feats()
    model.train()
    results = []
    for remat in (True, False):
        model.routing_remat = remat
        model.zero_grad()
        out = model(torch.tensor(feats), torch.tensor(lengths),
                    generator=torch.Generator().manual_seed(11))
        out.square().sum().backward()
        results.append([out.detach()] + [p.grad.clone()
                                         for p in model.parameters()])
    for got, want in zip(*results):
        assert torch.equal(got, want)
    with torch.no_grad():
        evaluated = model.eval()(torch.tensor(feats), torch.tensor(lengths))
    assert not torch.allclose(results[0][0], evaluated)


def _config(*extra):
    logger = Logger(name="test_torch_wavefront", level=Logger.WARN).logger
    return ParseOption(
        ["wavefront", "--path-base=.", "--feat-dim=8",
         "--model-encoder-num=3", "--model-caps-primary-num=4",
         "--model-caps-primary-dim=4", "--model-caps-convolution-num=3",
         "--model-caps-convolution-dim=4", "--model-caps-class-dim=4",
         "--model-caps-type=naive", "--model-caps-context=True",
         "--model-caps-iter=1", "--model-caps-window-lpad=1",
         "--model-caps-window-rpad=1", "--model-conv-filter-num=4",
         "--tpu-routing-kernel=wavefront", *extra],
        logger, is_print_opts=False).args


def test_registry_builds_the_wavefront_and_refuses_bf16_routing():
    """The registry builds the wavefront model; with bf16 routing it raises
    the ValueError JAX's model raises in its forward, and so does the
    port's forward."""
    model, div = registry.build_model(_config(), 9)
    assert model.routing_impl == "wavefront" and model.routing_remat
    assert div == 4
    flax_model = FlaxSequenceRouter(**MODEL_KW, caps_iter=1, lpad=1, rpad=1,
                                    routing_impl="wavefront",
                                    routing_bf16=True)
    with pytest.raises(ValueError) as jax_error:
        random_flax_variables(flax_model, 123)
    with pytest.raises(ValueError) as build_error:
        registry.build_model(_config("--tpu-routing-bf16=True"), 9)
    port = SequenceRouter(**MODEL_KW, caps_iter=1, lpad=1, rpad=1,
                          routing_impl="wavefront", routing_bf16=True)
    with pytest.raises(ValueError) as forward_error:
        port(torch.zeros(1, 8, 123), torch.tensor([8]))
    assert (str(build_error.value) == str(forward_error.value)
            == str(jax_error.value))
