"""The port's CTC loss against srf_tpu's (optax) on the same numpy logits:
blank last, label 0 a real class, logit lengths ceil(inp_len / 4) capped at
T'. Per-example losses within rtol 1e-5 and logit gradients within atol
1e-5 (float32 forward-backward recursions in two libraries; measured
~1e-6). Infeasible alignments: optax returns ~1e5 and the port
INFEASIBLE_LOSS with a zero gradient (see ``srf_tpu_torch/ops/ctc.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.ops import ctc as jax_ctc
from srf_tpu_torch.ops import ctc

torch.set_num_threads(1)

IN_LEN_DIV = 4


def _problem(seed=0, batch=4, frames=40, vocab=7, max_labels=5):
    rng = np.random.RandomState(seed)
    t_sub = -(-frames // IN_LEN_DIV)
    logits = (2.0 * rng.randn(batch, t_sub, vocab)).astype(np.float32)
    inp_len = np.array([frames, frames - 5, 17, frames + 9][:batch], np.int32)
    tar_len = np.array([max_labels, 3, 2, 1][:batch], np.int32)
    # ids 0..vocab-2: 0 is a real class, vocab-1 the blank; a repeat in row 0
    labels = rng.randint(0, vocab - 1, size=(batch, max_labels))
    labels = labels.astype(np.int32)
    labels[0, :2] = 0
    return logits, inp_len, labels, tar_len


def _jax_loss_and_grad(logits, inp_len, labels, tar_len):
    def total(lg):
        pe = jax_ctc.ctc_loss_from_frames(lg, jnp.asarray(inp_len), IN_LEN_DIV,
                                          jnp.asarray(labels),
                                          jnp.asarray(tar_len))
        return jnp.sum(pe), pe

    (_, pe), grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(logits))
    return np.asarray(pe), np.asarray(grad)


def _port_loss_and_grad(logits, inp_len, labels, tar_len):
    lg = torch.from_numpy(logits).requires_grad_()
    pe = ctc.ctc_loss_from_frames(lg, torch.from_numpy(inp_len), IN_LEN_DIV,
                                  torch.from_numpy(labels),
                                  torch.from_numpy(tar_len))
    pe.sum().backward()
    return pe.detach().numpy(), lg.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradients_match_optax(seed):
    problem = _problem(seed=seed)
    want_pe, want_grad = _jax_loss_and_grad(*problem)
    got_pe, got_grad = _port_loss_and_grad(*problem)
    np.testing.assert_allclose(got_pe, want_pe, rtol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=1e-5)


def test_ctc_loss_blank_argument():
    logits, inp_len, labels, tar_len = _problem(seed=2)
    logits = logits[:, :, ::-1].copy()  # blank first, labels shifted up
    lengths = np.minimum(-(-inp_len // IN_LEN_DIV), logits.shape[1])
    want = jax_ctc.ctc_loss(jnp.asarray(logits), jnp.asarray(lengths),
                            jnp.asarray(labels + 1), jnp.asarray(tar_len),
                            blank_id=0)
    got = ctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(lengths),
                       torch.from_numpy(labels + 1), torch.from_numpy(tar_len),
                       blank_id=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_ctc_loss_keeps_float64_and_promotes_half_types():
    """float64 logits stay float64 through the log-softmax and the loss (a
    float64 run is a float64 reference); bfloat16 ones are promoted to
    float32."""
    logits, inp_len, labels, tar_len = _problem(seed=4)
    args = (torch.from_numpy(inp_len), IN_LEN_DIV, torch.from_numpy(labels),
            torch.from_numpy(tar_len))
    lg64 = torch.from_numpy(logits).double().requires_grad_()
    pe64 = ctc.ctc_loss_from_frames(lg64, *args)
    pe64.sum().backward()
    assert pe64.dtype == lg64.grad.dtype == torch.float64
    pe32 = ctc.ctc_loss_from_frames(torch.from_numpy(logits), *args)
    np.testing.assert_allclose(pe64.detach().numpy(), pe32.numpy(), rtol=1e-5)
    half = ctc.ctc_loss_from_frames(torch.from_numpy(logits).bfloat16(), *args)
    assert half.dtype == torch.float32


def test_infeasible_alignment_is_large_finite_with_zero_gradient():
    logits, inp_len, labels, tar_len = _problem(seed=3)
    # row 1: 2 logit frames for 3 labels; row 2: 2 frames, labels "a a"
    # need 3 (the repeat needs a blank between)
    inp_len[1], tar_len[1] = 8, 3
    inp_len[2], tar_len[2] = 8, 2
    labels[2, :2] = 4
    want_pe, want_grad = _jax_loss_and_grad(logits, inp_len, labels, tar_len)
    got_pe, got_grad = _port_loss_and_grad(logits, inp_len, labels, tar_len)
    assert np.all(want_pe[1:3] > 9e4)  # optax: ~1e5 plus its best path
    np.testing.assert_array_equal(got_pe[1:3], ctc.INFEASIBLE_LOSS)
    np.testing.assert_array_equal(got_grad[1:3], 0.0)
    for row in (0, 3):  # feasible rows are unaffected
        np.testing.assert_allclose(got_pe[row], want_pe[row], rtol=1e-5)
        np.testing.assert_allclose(got_grad[row], want_grad[row], atol=1e-5)
