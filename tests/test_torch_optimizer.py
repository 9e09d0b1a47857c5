"""The port's optimizer against srf_tpu's (optax) on the same sequence of
numpy gradients: Adam under the Noam schedule with timit.conf's betas and
eps (0.9, 0.98, 1e-9) and warmup 4 so that the rate is not ~0, plain Adam
and SGD, at k = 0.05. Parameters within rtol 1e-5 after 5 updates (float32
moments in two libraries; the schedule is float64 here and float32 in JAX;
optax forms Adam's bias correction 1 - b2^t in float32, which for optax's
default b2 = 0.999 is 1.3e-5 off at t = 1, so the error of each update
grows with the rate: ~1e-6 at this k). Also the
schedule itself, and the first update's rate at the recipe's warmup 1200:
optax reads the schedule at count 0, 1.2e-14."""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu_torch.train import optimizer

torch.set_num_threads(1)


def _config(opti_type=None, warmup=4, k=0.05):
    return types.SimpleNamespace(
        train_opti_type=opti_type, train_lr_param_k=k, model_dimension=1,
        train_warmup_n=warmup, train_lr_max=1e3, train_adam_beta1=0.9,
        train_adam_beta2=0.98, train_adam_epsilon=1e-9)


@pytest.mark.parametrize("opti_type", [None, "adam", "sgd"])
def test_updates_match_optax(opti_type):
    config = _config(opti_type)
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]

    tx, _ = jax_optimizer.get_optimizer(config)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jax_params)
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jax_params)
        jax_params = {k: jax_params[k] + updates[k] for k in jax_params}

    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in params.items()}
    opt, scheduler = optimizer.get_optimizer(config, torch_params.values())
    assert (scheduler is None) == (opti_type is not None)
    for g in grads:
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        if scheduler is not None:
            scheduler.step()
    for k, p in torch_params.items():
        moved = np.abs(np.asarray(jax_params[k]) - params[k]).max()
        assert moved > 1e-3, "the rate must not be ~0 in this test"
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jax_params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 3, 4, 100, 10 ** 6])
def test_noam_schedule_matches(step):
    want = jax_optimizer.noam_schedule(0.5, 1, 4, max_lr=0.2)(step)
    got = optimizer.noam_schedule(0.5, 1, 4, max_lr=0.2)(step)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_first_update_uses_the_schedule_at_count_zero():
    config = _config(warmup=1200, k=0.5)
    want = float(jax_optimizer.noam_schedule(0.5, 1, 1200)(0))
    assert abs(want - 1.2e-14) < 1e-16
    param = torch.nn.Parameter(torch.zeros(2))
    opt, scheduler = optimizer.get_optimizer(config, [param])
    np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=1e-6)
    param.grad = torch.ones(2)
    opt.step()
    scheduler.step()
    # the second update reads count 1: 0.5 * 1200^-1.5 = 1.2e-5
    np.testing.assert_allclose(opt.param_groups[0]["lr"],
                               float(jax_optimizer.noam_schedule(
                                   0.5, 1, 1200)(1)), rtol=1e-6)
