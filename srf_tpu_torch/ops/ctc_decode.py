"""CTC greedy decoding (port of the greedy part of ``srf_tpu/ops/ctc_decode.py``).

Best path: argmax -> collapse repeats -> drop blanks, vectorised on the
tensor's device. Callers pass floor ``inp_len // in_len_div`` lengths in
decode mode (reference: tfsr/trainer_sr.py:109-112).
"""

import torch


def greedy_decode_frames(logits, logit_lengths, blank_id=None):
    """Best-path decode with per-symbol emission frames.

    Returns (ids [B, T], lengths [B], frames [B, T]): ``frames[b, i]`` is
    the logit-frame index where ``ids[b, i]`` was emitted (the FIRST frame
    of its argmax run, the standard CTC timestamp convention). ids are
    left-aligned by a stable compaction; padded slots hold 0.
    """
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    batch, maxlen, _ = logits.shape
    best = torch.argmax(logits, dim=-1)  # [B, T]; first max on ties
    positions = torch.arange(maxlen, device=logits.device)[None, :]
    valid = positions < logit_lengths[:, None]
    prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], dim=1)
    keep = valid & (best != blank_id) & (best != prev)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    compacted = torch.gather(best, 1, order)
    frames = torch.gather(positions.expand_as(best), 1, order)
    lengths = keep.sum(dim=1)
    mask = positions < lengths[:, None]
    return (
        torch.where(mask, compacted, 0),
        lengths,
        torch.where(mask, frames, 0),
    )


def greedy_decode(logits, logit_lengths, blank_id=None):
    """Best-path decode. Returns (ids [B, T], lengths [B]); ids are
    left-aligned, padded with zeros past each length."""
    ids, lengths, _ = greedy_decode_frames(logits, logit_lengths, blank_id)
    return ids, lengths
