"""Auxiliary losses: label-smoothing cross-entropy, MWER's expected error,
perplexity and the word2vec weighted binary cross-entropy (port of
``srf_tpu/train/losses.py``; the reference's loss library,
tfsr/helper/train_helper.py:78-267).

- :func:`loss_ce` with neighbour smoothing (Chorowski'16) or uniform label
  smoothing (reference: train_helper.py:78-146),
- :func:`loss_ewerr`: the expected word error over an n-best list
  (Prabhavalkar et al., ICASSP 2018; reference: train_helper.py:192-267),
  which MWER training takes (``train/mwer.py``),
- :func:`ppl`: the masked sum of token negative log-probabilities
  (reference: train_helper.py:171-189),
- :func:`loss_function_w2v`: weighted binary cross-entropy from logits
  (reference: train_helper.py:149-157).

Plain PyTorch on any device; the attention-decoder losses are not wired
into the CTC trainers, here as in JAX.
"""


import torch
import torch.nn.functional as F

from srf_tpu_torch.config.constants import Constants


def loss_function_w2v(real, pred, weights, smoothing=0.0):
    """Weighted binary cross-entropy from logits, summed: the mean over the
    last axis of each example, times its weight."""
    real = real.float()
    if smoothing:
        real = real * (1.0 - smoothing) + 0.5 * smoothing
    per_elem = (torch.clamp(pred, min=0.0) - pred * real
                + torch.log1p(torch.exp(-pred.abs())))
    return torch.sum(per_elem.mean(dim=-1) * weights)


def _loss_sm_neighbor(labels, logits, confidence, output_dim):
    """Neighbourhood label smoothing: mass (1 - c) / 2 on each adjacent
    label of the sequence; padding (label 0) masked out."""
    ex_real = F.one_hot(labels.long(), output_dim).to(logits.dtype)
    if 0.0 < confidence < 1.0:
        left = F.pad(ex_real[:, 1:, :], (0, 0, 0, 1))
        right = F.pad(ex_real[:, :-1, :], (0, 0, 1, 0))
        ex_real = (ex_real * confidence + left * ((1 - confidence) / 2)
                   + right * ((1 - confidence) / 2))
    loss = -torch.sum(ex_real * torch.log_softmax(logits, dim=-1), dim=-1)
    return loss * (labels != 0).to(loss.dtype)


def _loss_sm_label(labels, logits, confidence, output_dim):
    """Uniform label smoothing with the minimum-entropy normaliser
    subtracted (transformer-official style); padding masked out."""
    low_confidence = (1.0 - confidence) / (output_dim - 1)
    one_hot = F.one_hot(labels.long(), output_dim).to(logits.dtype)
    soft_targets = one_hot * confidence + (1.0 - one_hot) * low_confidence
    xentropy = -torch.sum(soft_targets * torch.log_softmax(logits, dim=-1),
                          dim=-1)
    # in float32, as JAX takes jnp.log of the Python floats
    f32 = torch.tensor
    norm_const = -(
        f32(confidence) * torch.log(f32(confidence))
        + f32((output_dim - 1) * low_confidence)
        * torch.log(f32(low_confidence + 1e-20)))
    xentropy = xentropy - norm_const.to(xentropy.device)
    return xentropy * (labels != 0).to(xentropy.dtype)


def loss_ce(smoothing_type, labels, logits, confidence, output_dim):
    """[B, L] per-token smoothed cross-entropy, or None for another
    ``smoothing_type``."""
    if smoothing_type == Constants.SM_NEIGHBOR:
        return _loss_sm_neighbor(labels, logits, confidence, output_dim)
    if smoothing_type == Constants.SM_LABEL:
        return _loss_sm_label(labels, logits, confidence, output_dim)
    return None


def ppl(labels, logits, seq_len):
    """Sum of the token negative log-probabilities at positions before
    each row's ``seq_len``."""
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                        labels.long()[..., None])[..., 0]
    positions = torch.arange(nll.shape[1], device=nll.device)
    mask = (positions[None, :] < seq_len.to(nll.device)[:, None])
    return torch.sum(nll * mask.to(nll.dtype))


def loss_ewerr(word_errors, lprobss):
    """Expected word-error loss over n-best hypotheses: [B, N] edit
    distances and hypothesis log-probabilities -> [B] losses
    ``sum_i P_hat(y_i) (WE_i - mean WE)``, P_hat the softmax over the beam
    (the renormalised distribution, max-subtracted so that long utterances
    do not underflow)."""
    p_hat = torch.softmax(lprobss, dim=-1)
    w_hat = word_errors.mean(dim=-1, keepdim=True)
    return torch.sum(p_hat * (word_errors - w_hat), dim=-1)
