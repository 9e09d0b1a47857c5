"""CTC loss with the reference's blank-last convention (port of
``srf_tpu/ops/ctc.py``).

The blank class is the *last* logit and label id 0 is a real class (the PAD
symbol); padded label slots are identified by ``tar_len``, not by a reserved
id (reference: tfsr/trainer_sr.py:64-66,130-136). The JAX package computes
the loss with ``optax.ctc_loss`` outside any Pallas kernel; here it is
``F.ctc_loss`` on the log-softmax.

``F.ctc_loss`` reads the lengths on the host: lengths given on the card
are copied back, a copy that waits for everything queued before it (the
whole forward). Lengths given on the host cost nothing; the train step
takes them either way.

Infeasible alignments (fewer logit frames than the labels need: one per
label plus one per adjacent repeat) differ between the libraries: optax
returns a large finite loss (~1e5, its log-epsilon) with a bounded gradient,
``F.ctc_loss`` returns inf and NaN gradients. The port returns
:data:`INFEASIBLE_LOSS` for such an utterance and a zero gradient (as
``zero_infinity`` does), so the loss stays finite and large as in optax and
one bad utterance cannot turn the step's gradients into NaN; the gradient of
that utterance is zero where optax's is not.
"""

import torch
import torch.nn.functional as F

from srf_tpu_torch.ops.masking import subsampled_lengths

# the loss of an infeasible alignment: optax's is 1e5 (-log_epsilon) plus
# the O(1) cost of its best path
INFEASIBLE_LOSS = 1e5


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id=None):
    """Per-example CTC negative log-likelihood.

    Args:
        logits: [B, T, K] raw logits, blank class at index K-1 unless
            ``blank_id`` given.
        logit_lengths: [B] valid frame counts (already subsampled), on
            the host or on the logits' device.
        labels: [B, L] dense labels, zero-padded (id 0 is a real class), on
            the logits' device.
        label_lengths: [B] valid label counts, on the host or the device.
    Returns:
        [B] loss vector, in the dtype of ``logits`` (float32 at least).
    """
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    if logits.dtype not in (torch.float32, torch.float64):
        logits = logits.float()  # half types: the loss in float32
    log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    logit_lengths = logit_lengths.to(torch.long)
    label_lengths = label_lengths.to(torch.long)
    loss = F.ctc_loss(log_probs, labels.to(torch.long), logit_lengths,
                      label_lengths, blank=blank_id, reduction="none",
                      zero_infinity=True)
    # frames a path needs: one per label, one more per adjacent repeat
    logit_lengths, label_lengths = (
        x.to(labels.device, non_blocking=True)
        for x in (logit_lengths, label_lengths))
    positions = torch.arange(1, labels.shape[1], device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (positions[None, :] < label_lengths[:, None])).sum(dim=1)
    feasible = logit_lengths >= label_lengths + repeats
    return torch.where(feasible, loss,
                       torch.full_like(loss, INFEASIBLE_LOSS))


def ctc_loss_from_frames(logits, inp_len, in_len_div, labels, tar_len,
                         blank_id=None):
    """CTC loss from raw frame lengths and the conv divisor: logit lengths
    are ``min(ceil(inp_len / in_len_div), T')`` (reference:
    trainer_sr.py:65)."""
    logit_lengths = torch.clamp(subsampled_lengths(inp_len, in_len_div),
                                max=logits.shape[1])
    return ctc_loss(logits, logit_lengths, labels, tar_len, blank_id)
