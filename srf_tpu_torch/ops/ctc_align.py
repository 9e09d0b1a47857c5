"""CTC forced alignment: Viterbi-align a known transcript to logits (port of
``srf_tpu/ops/ctc_align.py``).

Given frame logits and the reference label sequence, find the most
probable CTC path that spells exactly that sequence, and so each token's
start and end frames.

The 2L+1-state trellis (blank, y1, blank, y2, ..., blank) is swept over
the frames on the logits' device with a max-plus carry ``alpha`` [B, S];
each frame's transition choices (stay / from the previous state / skip
over a blank) go on a [B, T, S] uint8 tape. The backtrace and the
per-token span extraction run on the device too, so only the [B, L]
starts and ends and the [B] scores come to the host; the tape never does.
"""

import numpy as np
import torch

NEG = -1e30


def _align_spans_batch(logp, lengths, labels, label_lengths, blank_id):
    """Trellis sweep, backtrace and spans on ``logp``'s device:
    logp [B, T, V], lengths / label_lengths [B], labels [B, L] ->
    (starts [B, L], ends [B, L], scores [B]). Frames at or past a row's
    length freeze its carry (choice 0, stay)."""
    B, T, _ = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    device = logp.device
    z = torch.full((B, S), blank_id, dtype=torch.int64, device=device)
    z[:, 1::2] = labels
    s_pos = torch.arange(S, device=device)
    # states past the valid extent (beyond 2*label_length) are dead
    s_valid = s_pos[None] < 2 * label_lengths[:, None] + 1
    # skip s-2 -> s for non-blank states whose symbol differs from the one
    # two states back (the CTC rule)
    z_m2 = torch.cat([torch.full((B, 2), -1, dtype=z.dtype, device=device),
                      z[:, :-2]], dim=1)
    can_skip = (s_pos[None] % 2 == 1) & (z != z_m2) & (s_pos[None] >= 2)
    neg = torch.full((B, S), NEG, device=device)
    lp_z = logp.gather(2, z[:, None, :].expand(B, T, S))  # [B, T, S]

    alpha = torch.where(s_pos[None] == 0, 0.0, neg)  # start in state 0 or 1
    alpha = torch.where((s_pos[None] == 1) & (label_lengths[:, None] > 0),
                        0.0, alpha)
    alpha = torch.where(s_valid, alpha + lp_z[:, 0], neg)
    choices = torch.zeros((B, T, S), dtype=torch.uint8, device=device)
    neg1 = neg[:, :1]
    for t in range(1, T):
        prev = torch.cat([neg1, alpha[:, :-1]], dim=1)
        skip = torch.where(can_skip,
                           torch.cat([neg[:, :2], alpha[:, :-2]], dim=1), NEG)
        stacked = torch.stack([alpha, prev, skip])  # [3, B, S]
        best = stacked.amax(dim=0)
        choice = stacked.argmax(dim=0)  # the first maximum, as jnp.argmax
        new = torch.where(s_valid, best + lp_z[:, t], neg)
        active = (lengths > t)[:, None]
        alpha = torch.where(active, new, alpha)
        choices[:, t] = torch.where(active, choice.to(torch.uint8), 0)

    # backtrace from the better of the last two states (ties: the final
    # blank), as the host walk does
    s_true = 2 * label_lengths + 1
    fin = torch.where(s_pos[None] < s_true[:, None], alpha, neg)
    end1 = s_true - 1
    end2 = (s_true - 2).clamp_min(0)
    fin1 = fin.gather(1, end1[:, None])[:, 0]
    fin2 = fin.gather(1, end2[:, None])[:, 0]
    s = torch.where((label_lengths > 0) & (fin2 > fin1), end2, end1)
    scores = fin.gather(1, s[:, None])[:, 0]
    states = torch.empty((B, T), dtype=torch.int64, device=device)
    for t in range(T - 1, -1, -1):
        active = lengths > t
        states[:, t] = torch.where(active, s, -1)
        step = choices[:, t].gather(1, s[:, None])[:, 0].long()
        s = torch.where(active, s - step, s)
    tok_states = 2 * torch.arange(L, device=device) + 1
    eq = states[:, None, :] == tok_states[None, :, None]  # [B, L, T]
    tpos = torch.arange(T, device=device)
    starts = torch.where(eq, tpos, T).amin(dim=2)
    ends = torch.where(eq, tpos, -1).amax(dim=2) + 1
    return starts, ends, scores


def ctc_forced_align(logits, logit_lengths, labels, label_lengths,
                     blank_id=None):
    """Batched forced alignment on the logits' device.

    Args:
        logits: [B, T, V] (pre-softmax), a tensor (or numpy, for the CPU).
        logit_lengths: [B] valid frame counts.
        labels: [B, L] reference ids (right-padded).
        label_lengths: [B] reference lengths.
    Returns:
        per utterance (a list of {"id", "start", "end"} per token, score):
        ``start`` = first frame the Viterbi path occupies the token's
        state, ``end`` = last such frame + 1; score = the Viterbi path's
        log-prob. An infeasible alignment (more label states than valid
        frames, or an all-NEG trellis) gives (None, -inf).
    """
    logits = torch.as_tensor(logits)
    device = logits.device
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    logit_lengths = np.asarray(logit_lengths)
    label_lengths = np.asarray(label_lengths)
    labels = np.asarray(labels)
    with torch.inference_mode():
        logp = torch.log_softmax(logits.float(), dim=-1)
        starts, ends, scores = _align_spans_batch(
            logp, torch.as_tensor(logit_lengths, device=device),
            torch.as_tensor(labels, dtype=torch.int64, device=device),
            torch.as_tensor(label_lengths, device=device), blank_id)
        starts, ends = starts.cpu().numpy(), ends.cpu().numpy()
        scores = scores.cpu().numpy()
    out = []
    for b in range(logits.shape[0]):
        n, m = int(logit_lengths[b]), int(label_lengths[b])
        # the trellis needs enough frames to visit every label state
        if n <= 0 or m < 0 or 2 * m + 1 > 2 * n + 1 or (m > 0 and n < m):
            out.append((None, float("-inf")))
            continue
        score = float(scores[b])
        if not np.isfinite(score) or score <= NEG / 2:
            out.append((None, float("-inf")))
            continue
        spans = [{"id": int(labels[b, i]), "start": int(starts[b, i]),
                  "end": int(ends[b, i])} for i in range(m)]
        out.append((spans, score))
    return out
