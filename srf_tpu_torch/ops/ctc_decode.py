"""CTC decoding (port of ``srf_tpu/ops/ctc_decode.py``): greedy on the
tensor's device, and the host prefix beam search.

- :func:`greedy_decode`: argmax -> collapse repeats -> drop blanks,
  vectorised on the logits' device.
- :func:`prefix_beam_search`: merged-prefix beam search (blank/non-blank
  probability split per prefix), numpy on the host, with optional n-gram
  shallow fusion; the oracle for the device beam (ops/ctc_beam.py).
- :func:`beam_search_native`: the same search in C++
  (``csrc/host/ctc_beam.cc``, built with g++ at first use);
  :func:`beam_search_batch` takes it when it is built and no LM is fused,
  the Python search otherwise.

Callers pass floor ``inp_len // in_len_div`` lengths in decode mode
(reference: tfsr/trainer_sr.py:109-112).
"""

import math

import numpy as np
import torch

LOG_ZERO = -1e30


def _logsumexp2(a, b):
    if a <= LOG_ZERO:
        return b
    if b <= LOG_ZERO:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


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


def prefix_beam_search(logits, logit_length, beam_width=100, blank_id=None,
                       top_paths=1, lm=None, return_frames=False):
    """Merged-prefix CTC beam search for one utterance.

    Args:
        logits: [T, K] numpy logits (pre-softmax).
        logit_length: number of valid frames.
        lm: optional (ngram_lm.NGramLM, weight, bonus) — shallow fusion:
            beams are pruned and finally ranked by
            ``ctc + weight*logP_lm(prefix) + bonus*len(prefix)``. This is
            the host oracle for the on-device fused beam
            (ops/ctc_beam_jax.py).
        return_frames: also return each hypothesis's per-symbol emission
            frames (the frame at which each symbol first entered the
            prefix — merged prefixes keep the EARLIEST creation, matching
            the device beam's backpointer-tape convention).
    Returns:
        list of (ids, neg_score) tuples, best first — or
        (ids, neg_score, frames) with ``return_frames``.
    """
    logits = np.asarray(logits, np.float64)
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    if beam_width is None:
        # never run unpruned (beams grow exponentially); 100 is the
        # reference default (tf.nn.ctc_beam_search_decoder)
        beam_width = 100
    log_probs = logits - _np_logsumexp(logits)
    lm_cache = {(): 0.0}

    def _lm_score(prefix):
        # accumulated weighted LM score of a prefix; parents are always
        # cached before their extensions appear
        score = lm_cache.get(prefix)
        if score is None:
            lm_obj, weight, bonus = lm
            score = (
                _lm_score(prefix[:-1])
                + weight * lm_obj.logp(
                    _lm_ctx(lm_obj, prefix[:-1]), prefix[-1]
                )
                + bonus
            )
            lm_cache[prefix] = score
        return score

    def _rank(prefix, pb, pnb):
        score = _logsumexp2(pb, pnb)
        if lm is not None and score > LOG_ZERO:
            score += _lm_score(prefix)
        return score

    # beams: prefix tuple -> [p_blank, p_non_blank] (log)
    beams = {(): [0.0, LOG_ZERO]}
    # prefix -> per-symbol emission frames; recorded for pruning SURVIVORS
    # only (every parent is a survivor of an earlier step, so its frames
    # always exist), earliest creation wins (setdefault)
    first_frames = {(): ()}
    for t in range(int(logit_length)):
        lp = log_probs[t]
        # prune symbols below a floor to keep the python loop tractable
        candidates = np.nonzero(lp > -18.0)[0]
        if candidates.size == 0:
            candidates = np.array([int(np.argmax(lp))])
        new_beams = {}

        def _acc(prefix, is_blank, value):
            entry = new_beams.setdefault(prefix, [LOG_ZERO, LOG_ZERO])
            idx = 0 if is_blank else 1
            entry[idx] = _logsumexp2(entry[idx], value)

        for prefix, (p_b, p_nb) in beams.items():
            p_tot = _logsumexp2(p_b, p_nb)
            last = prefix[-1] if prefix else None
            for sym in candidates:
                sym = int(sym)
                lp_s = float(lp[sym])
                if sym == blank_id:
                    _acc(prefix, True, p_tot + lp_s)
                elif sym == last:
                    # repeated symbol: stays the same prefix from non-blank
                    # paths, extends it from blank-ending paths
                    _acc(prefix, False, p_nb + lp_s)
                    _acc(prefix + (sym,), False, p_b + lp_s)
                else:
                    _acc(prefix + (sym,), False, p_tot + lp_s)
        scored = sorted(
            new_beams.items(),
            key=lambda kv: -_rank(kv[0], kv[1][0], kv[1][1]),
        )
        beams = dict(scored[:beam_width])
        if return_frames:
            for prefix in beams:
                if prefix not in first_frames:
                    first_frames[prefix] = (
                        first_frames[prefix[:-1]] + (t,)
                    )
    results = sorted(
        ((prefix, _rank(prefix, pb, pnb))
         for prefix, (pb, pnb) in beams.items()),
        key=lambda kv: -kv[1],
    )
    if return_frames:
        return [
            (list(prefix), -score, list(first_frames.get(prefix, ())))
            for prefix, score in results[:top_paths]
        ]
    return [
        (list(prefix), -score) for prefix, score in results[:top_paths]
    ]


def _lm_ctx(lm_obj, prefix):
    """LM context id after consuming ``prefix`` (host-side)."""
    ctx = lm_obj.ctx0
    for sym in prefix[-(lm_obj.order - 1):] if lm_obj.order > 1 else ():
        ctx = lm_obj.next_ctx(ctx, sym)
    return ctx


def _np_logsumexp(x):
    m = np.max(x, axis=-1, keepdims=True)
    return m + np.log(np.sum(np.exp(x - m), axis=-1, keepdims=True))


def beam_search_native(logits_tk, logit_length, beam_width, blank_id):
    """C++ prefix beam search for one utterance; None if the library is
    unavailable. ``beam_search_native.calls`` counts the decodes it ran."""
    import ctypes

    from srf_tpu_torch.utils.native import load_host_lib

    lib = load_host_lib()
    if not lib:
        return None
    arr = np.ascontiguousarray(logits_tk[: int(logit_length)], np.float32)
    t, k = arr.shape
    out = np.zeros((t + 1,), np.int32)
    n = lib.srf_ctc_beam_search(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, k, int(beam_width), int(blank_id),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size,
    )
    if n < 0:
        return None
    beam_search_native.calls += 1
    return [int(x) for x in out[:n]]


beam_search_native.calls = 0


def beam_search_batch(logits, logit_lengths, beam_width=100, blank_id=None,
                      lm=None):
    """Decode a [B, T, K] batch on host; returns list of id lists.

    Uses the native C++ decoder when built, the Python implementation
    otherwise (same algorithm; the Python one additionally prunes symbols
    below a -18 logprob floor). Shallow fusion (``lm``) always takes the
    Python path — the C++ decoder is acoustic-only.
    """
    logits = np.asarray(logits)
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    out = []
    for i in range(logits.shape[0]):
        if lm is None:
            native = beam_search_native(
                logits[i], logit_lengths[i], beam_width, blank_id
            )
            if native is not None:
                out.append(native)
                continue
        hyps = prefix_beam_search(
            logits[i], int(logit_lengths[i]), beam_width, blank_id, lm=lm
        )
        out.append(hyps[0][0] if hyps else [])
    return out
