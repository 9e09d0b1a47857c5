"""CTC beam search on the logits' device (port of ``srf_tpu/ops/ctc_beam_jax.py``).

Merged-prefix beam search with the blank/non-blank probability split, one
step per frame, each step a fixed sequence of torch ops over the whole
batch (batch is the leading dimension of every state tensor, [B, W]); the
decode never leaves the device until its compact result is read back.

Prefix identity is a rolling hash ``h(p+s) = h(p)*M + s+1 (mod 2^32)`` with
M odd, so M is invertible mod 2^32. Beams hold unique prefixes, so an extend
candidate (beam i + symbol s) can only collide with a STAY candidate
(p_i+s == p_j), and each stay has at most one merging extend, the one from
its parent prefix: each step recovers every stay's parent hash in closed
form, ``h(parent_j) = (h(p_j) - (last_j+1)) * M^-1``, matches it against
the W beam hashes (a [W, W] compare), folds the matched extend into the
stay's non-blank mass, kills that extend, and keeps the top W of stays and
surviving extends. Backpointers (parent beam, appended symbol) go on a
[B, T, W] int16 tape; the best path is walked back on the device.

Semantics kept from the JAX package, so that decodes are the same:

- hashes are JAX's uint32 values, carried in int64 and masked to 32 bits;
  the products by M^-1 (a 32-bit constant) are formed from its 16-bit
  halves, so no int64 product overflows (:func:`_mul_u32`);
- the top-W are taken by a stable descending sort, so equal scores keep
  ``lax.top_k``'s order (the lower candidate index first);
- the dead-extend set is a boolean ``any`` (JAX's 0/1 matmul), and the
  first true of a boolean row is found explicitly (JAX's ``argmax``);
- one parent gather per step rebuilds the winners' fields (two here: the
  float and the integer fields), and a dead extend winner is recognised
  by its top-W value;
- the LM context and score ride in the state only when an LM is fused;
- the remerge rule for timestamps, and frozen rows past ``length`` record
  identity parents and sym -1.

``topk_approx`` (JAX's ``lax.approx_max_k``, TPU's binned top-k) has no
counterpart here and is refused, as is ``SRF_BEAM_TOPK=approx``.

Optional shallow fusion (``lm=`` (NGramLM, weight, bonus), or the same
with the table already on the device, :func:`lm_on_device`): candidates are
ranked and finally selected by ``ctc + weight*lm + bonus*|y|``; the CTC
mass stays pure, so merges stay exact.
"""

import os
from typing import NamedTuple

import numpy as np
import torch

NEG = -1e30
MASK32 = 0xFFFFFFFF
_HASH_MUL = 1000003
# modular inverse of the hash multiplier (1000003 is odd): recovers a
# prefix hash from its child's, h(p) = (h(p+s) - (s+1)) * M^-1 mod 2^32
_HASH_MUL_INV = pow(1000003, -1, 2**32)
_DUMMY_HASH_STEP = 2654435761


def _mul_u32(h, m):
    """``h * m mod 2^32`` for int64 tensors ``h`` in [0, 2^32) and a 32-bit
    constant ``m``, from m's 16-bit halves: each partial product stays below
    2^48, so nothing overflows int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK32


def _check_topk(topk_approx):
    if topk_approx is None:
        topk_approx = os.environ.get("SRF_BEAM_TOPK", "") == "approx"
    if topk_approx:
        raise NotImplementedError(
            "topk_approx (SRF_BEAM_TOPK=approx) is TPU's approx_max_k; the "
            "port's beam takes the exact top-k only")


def _lse(a, b):
    """log(exp(a) + exp(b)) with NEG as log 0 (both NEG stays NEG)."""
    out = torch.logaddexp(a.clamp_min(NEG), b.clamp_min(NEG))
    return torch.where((a <= NEG) & (b <= NEG), NEG, out)


def _first_true(mask):
    """Index of the first True along the last axis, 0 where there is none
    (``jnp.argmax`` of a boolean row)."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    first = torch.where(mask, idx, n).amin(dim=-1)
    return torch.where(first == n, 0, first)


def _first_max(scores):
    """Index of the first maximum along the last axis."""
    return _first_true(scores == scores.amax(dim=-1, keepdim=True))


def beam_init(beam_width, lm_ctx0=0, with_lm=None, batch=1, device=None):
    """Fresh beam state for ``batch`` utterances: beam 0 holds the empty
    prefix, the rest are dead. ``with_lm`` (default: iff ``lm_ctx0`` is
    given; an order-1 LM's ctx0 is 0, so LM callers pass True): carry the
    shallow-fusion fields (LM context id and accumulated weighted LM score
    per beam)."""
    W = beam_width
    if with_lm is None:
        with_lm = bool(lm_ctx0)
    idx = torch.arange(W, device=device)
    state = {
        # distinct dummy hashes so dead beams never merge
        "hash": ((17 + idx * _DUMMY_HASH_STEP) & MASK32).expand(batch, W)
                .clone(),
        "pb": torch.where(idx == 0, 0.0, NEG).float().expand(batch, W)
              .clone(),
        "pnb": torch.full((batch, W), NEG, device=device),
        "last": torch.full((batch, W), -1, dtype=torch.int64, device=device),
    }
    if with_lm:
        state["ctx"] = torch.full((batch, W), lm_ctx0, dtype=torch.int64,
                                  device=device)
        state["lm"] = torch.zeros((batch, W), device=device)
    return state


def _beam_chunk(state, logp, t0, length, blank_id, lm=None):
    """Advance the beam over one block of frames.

    ``logp`` [B, T, V] log-probs whose global frame indices are
    [t0, t0 + T), ``length`` [B] the valid lengths (frames at or past
    ``length``, or before 0, leave a row's state untouched). ``lm``:
    optional (table [C, V] log-probs on the device, order, weight, bonus).
    Returns (state, parents [B, T, W] int16, syms [B, T, W] int16).
    """
    B, W = state["hash"].shape
    T, K = logp.shape[1], logp.shape[2]
    # the backpointer tape is int16 (parent < W, sym < K)
    if K >= 2**15 or W >= 2**15:
        raise ValueError(
            "int16 backpointer tape requires vocab (%d) and beam width (%d)"
            " < 32768" % (K, W))
    if (lm is not None) != ("ctx" in state):
        raise ValueError(
            "beam state LM fields do not match the lm argument; create "
            "the state with beam_init(..., with_lm=%s)" % (lm is not None))
    device = logp.device
    syms_all = torch.arange(K, device=device)
    beams = torch.arange(W, device=device)
    blank_col = syms_all == blank_id
    length = torch.as_tensor(length, device=device).reshape(B)
    if lm is not None:
        lm_table, lm_order, lm_weight, lm_bonus = lm
        n_ctx, lm_vocab = lm_table.shape
        lm_base = lm_vocab + 1
        lm_keep = (lm_vocab + 1) ** max(lm_order - 2, 0)
        sym_clamped = syms_all.clamp_max(lm_vocab - 1)
    parents = torch.empty((B, T, W), dtype=torch.int16, device=device)
    syms = torch.empty((B, T, W), dtype=torch.int16, device=device)

    for step in range(T):
        t = t0 + step
        lp = logp[:, step]  # [B, K]
        pb, pnb = state["pb"], state["pnb"]
        last, hsh = state["last"], state["hash"]
        p_tot = _lse(pb, pnb)

        # --- stay candidates (one per beam): blank, or repeat of last ---
        lp_blank = lp[:, blank_id, None]
        last_safe = last.clamp_min(0)
        lp_last = torch.where(last >= 0, lp.gather(1, last_safe), NEG)
        stay_pb = torch.where(p_tot <= NEG, NEG, p_tot + lp_blank)
        stay_pnb = torch.where(pnb <= NEG, NEG, pnb + lp_last)

        # --- extend candidates (beam x K, blank column dead) ---
        is_repeat = syms_all == last[:, :, None]
        base = torch.where(is_repeat, pb[:, :, None], p_tot[:, :, None])
        ext_pnb = torch.where((base <= NEG) | blank_col, NEG,
                              base + lp[:, None, :])

        # --- merge each stay's unique parent extend into it ---
        # stay j merges with extend (i, last_j) iff hash_i == parent_hash_j
        parent_hash = _mul_u32((hsh - (last_safe + 1)) & MASK32,
                               _HASH_MUL_INV)
        base_ji = torch.where(last[:, :, None] == last[:, None, :],
                              pb[:, None, :], p_tot[:, None, :])
        match = ((parent_hash[:, :, None] == hsh[:, None, :])
                 & ((last >= 0) & (last != blank_id))[:, :, None]
                 & (base_ji > NEG))  # [B, W_stay, W_beam]
        has_match = match.any(dim=2)
        matched_i = _first_true(match)
        merged_in = torch.where(match, base_ji + lp_last[:, :, None],
                                NEG).amax(dim=2)
        # timestamps: where the merging extend carries more mass than the
        # stay's own, the tape records that extend (same prefix)
        remerge = has_match & (merged_in > _lse(stay_pb, stay_pnb))
        stay_pnb = torch.where(
            has_match, torch.logaddexp(stay_pnb.clamp_min(NEG), merged_in),
            stay_pnb)
        # kill merged extends: dead[i, s] = any_j match[j, i] & last_j == s
        # (rows with last_j < 0 never match)
        onehot_last = syms_all == last_safe[:, :, None]  # [B, W_stay, K]
        dead = (match[:, :, :, None] & onehot_last[:, :, None, :]).any(dim=1)

        # --- top-W over stays + surviving extends ---
        stay_tot = _lse(stay_pb, stay_pnb)
        if lm is None:
            rank_ext = torch.where(dead | (ext_pnb <= NEG), NEG, ext_pnb)
            rank_stay = torch.where(stay_tot <= NEG, NEG, stay_tot)
        else:
            # accumulated weighted LM score of each extended prefix;
            # symbols outside the LM vocab (the blank) only appear on
            # NEG-killed candidates, so the clamp is inert
            lm_row = lm_table[state["ctx"]][:, :, sym_clamped]  # [B, W, K]
            lm_ext = state["lm"][:, :, None] + lm_weight * lm_row + lm_bonus
            rank_ext = torch.where(dead | (ext_pnb <= NEG), NEG,
                                   ext_pnb + lm_ext)
            rank_stay = torch.where(stay_tot <= NEG, NEG,
                                    stay_tot + state["lm"])
        scores = torch.cat([rank_stay, rank_ext.reshape(B, W * K)], dim=1)
        # stable: equal scores keep the lower candidate index first
        top_val, top_idx = torch.sort(scores, dim=1, descending=True,
                                      stable=True)
        top_val, top_idx = top_val[:, :W], top_idx[:, :W]
        is_stay = top_idx < W
        ext_idx = (top_idx - W).clamp_min(0)
        ext_beam = ext_idx // K
        ext_sym = ext_idx % K

        # --- winner fields, rebuilt from the parent beam ---
        parent_i = torch.where(is_stay, top_idx, ext_beam)
        floats = [pb, pnb, merged_in]
        ints = [hsh, last, matched_i, has_match.long(), remerge.long()]
        if lm is not None:
            floats.append(state["lm"])
            ints.append(state["ctx"])
        fpar = torch.stack(floats, dim=-1).gather(
            1, parent_i[:, :, None].expand(B, W, len(floats)))
        ipar = torch.stack(ints, dim=-1).gather(
            1, parent_i[:, :, None].expand(B, W, len(ints)))
        pb_par, pnb_par, merged_par = fpar[..., 0], fpar[..., 1], fpar[..., 2]
        hash_par, last_par, mi_par = ipar[..., 0], ipar[..., 1], ipar[..., 2]
        hasm_par, rem_par = ipar[..., 3] == 1, ipar[..., 4] == 1

        ptot_par = _lse(pb_par, pnb_par)
        lp_last_par = torch.where(last_par >= 0,
                                  lp.gather(1, last_par.clamp_min(0)), NEG)
        # stay winner: stay_pb / merged stay_pnb of beam parent_i
        st_pb = torch.where(ptot_par <= NEG, NEG, ptot_par + lp_blank)
        st_pnb0 = torch.where(pnb_par <= NEG, NEG, pnb_par + lp_last_par)
        st_pnb = torch.where(
            hasm_par, torch.logaddexp(st_pnb0.clamp_min(NEG), merged_par),
            st_pnb0)
        # extend winner: a dead one (merge-killed, blank column, dead
        # source) is exactly a NEG-ranked one, so its top-W value says so
        ext_base = torch.where(ext_sym == last_par, pb_par, ptot_par)
        ex_pnb = torch.where(top_val <= NEG, NEG,
                             ext_base + lp.gather(1, ext_sym))
        # hash_par < 2^32 and M < 2^20: the product fits int64
        ex_hash = (hash_par * _HASH_MUL + ext_sym + 1) & MASK32

        sel = {
            "hash": torch.where(is_stay, hash_par, ex_hash),
            "pb": torch.where(is_stay, st_pb, NEG),
            "pnb": torch.where(is_stay, st_pnb, ex_pnb),
            "last": torch.where(is_stay, last_par, ext_sym),
        }
        if lm is not None:
            lm_par, ctx_par = fpar[..., 3], ipar[..., 5]
            # order 1 folds to context 0
            ext_ctx = ((ctx_par % lm_keep) * lm_base + ext_sym) % n_ctx
            sym_c = ext_sym.clamp_max(lm_vocab - 1)
            lm_ext_sel = (lm_par + lm_weight * lm_table[ctx_par, sym_c]
                          + lm_bonus)
            sel["ctx"] = torch.where(is_stay, ctx_par, ext_ctx)
            sel["lm"] = torch.where(is_stay, lm_par, lm_ext_sel)
        parent = torch.where(is_stay, torch.where(rem_par, mi_par, parent_i),
                             ext_beam)
        sym = torch.where(is_stay,
                          torch.where(rem_par, last_par.clamp_min(0), -1),
                          ext_sym)

        # freeze rows outside the valid range; they record identity
        # backpointers and sym -1, which the backtrace skips
        if t >= 0:
            active = (length > t)[:, None]
        else:
            active = torch.zeros((B, 1), dtype=torch.bool, device=device)
        state = {key: torch.where(active, sel[key], state[key])
                 for key in state}
        parents[:, step] = torch.where(active, parent, beams)
        syms[:, step] = torch.where(active, sym, -1)
    return state, parents, syms


def beam_scores(state):
    """Total score per beam: CTC mass plus the (weighted) fused-LM score
    accumulated in the state (pure CTC mass without an LM)."""
    ctc = _lse(state["pb"], state["pnb"])
    lm = state.get("lm")
    total = ctc if lm is None else ctc + lm
    return torch.where(ctc <= NEG, NEG, total)


class DeviceLM(NamedTuple):
    """An NGramLM's table on a device, with what the beam reads of it."""

    table: torch.Tensor
    order: int
    vocab_size: int
    ctx0: int


def lm_on_device(lm, device):
    """``lm`` = (NGramLM, weight, bonus) -> (DeviceLM, weight, bonus), the
    table copied to ``device``; done once where the LM is loaded, so that
    each beam call takes the table as it is (None stays None)."""
    if lm is None:
        return None
    lm_obj, weight, bonus = lm
    return (DeviceLM(torch.as_tensor(lm_obj.table, device=device),
                     lm_obj.order, lm_obj.vocab_size, lm_obj.ctx0),
            weight, bonus)


def lm_fusion_args(lm, n_classes, device):
    """Resolve ``lm`` = (NGramLM or DeviceLM, weight, bonus) into the
    keyword arguments of the beam entry points; ``n_classes`` is the logit
    vocab INCLUDING the appended CTC blank. An NGramLM's table is copied
    to ``device`` on every call (see :func:`lm_on_device`)."""
    if lm is None:
        return {}
    lm_obj, weight, bonus = lm
    if lm_obj.vocab_size != n_classes - 1:
        raise ValueError(
            "LM vocab %d does not match decoder vocab %d (+1 blank)"
            % (lm_obj.vocab_size, n_classes - 1)
        )
    return {
        "lm_table": torch.as_tensor(lm_obj.table, device=device),
        "lm_order": lm_obj.order,
        "lm_weight": float(weight),
        "lm_bonus": float(bonus),
        "lm_ctx0": lm_obj.ctx0,
    }


def _pack_lm(lm_table, lm_order, lm_weight, lm_bonus):
    if lm_table is None:
        return None
    return lm_table, lm_order, lm_weight, lm_bonus


def _log_probs(logits):
    return torch.log_softmax(torch.as_tensor(logits).float(), dim=-1)


def _beam_scan_batch(logits, lengths, beam_width, blank_id, lm_table=None,
                     lm_order=0, lm_weight=0.0, lm_bonus=0.0, lm_ctx0=0):
    """[B, T, V] -> (parents/syms [B, T, W] int16, scores [B, W])."""
    logp = _log_probs(logits)
    state = beam_init(beam_width, lm_ctx0, with_lm=lm_table is not None,
                      batch=logp.shape[0], device=logp.device)
    final, parents, syms = _beam_chunk(
        state, logp, 0, lengths, blank_id,
        _pack_lm(lm_table, lm_order, lm_weight, lm_bonus),
    )
    return parents, syms, beam_scores(final)


def beam_chunk_step(state, logits, t0, length, blank_id, lm_table=None,
                    lm_order=0, lm_weight=0.0, lm_bonus=0.0,
                    topk_approx=False):
    """One streamed block: advance ``state`` over logits [B, T, V] whose
    global frame indices are [t0, t0+T). Returns (state, parents, syms,
    scores)."""
    _check_topk(topk_approx)
    state, parents, syms = _beam_chunk(
        state, _log_probs(logits), t0, length, blank_id,
        _pack_lm(lm_table, lm_order, lm_weight, lm_bonus),
    )
    return state, parents, syms, beam_scores(state)


def _device_backtrace(parents, syms, scores):
    """Reverse walk of each utterance's tape on the device.

    parents/syms [B, T, W], scores [B, W] -> (ids [B, T], frames [B, T],
    lengths [B], best scores [B]), ids/frames left-aligned and
    zero-padded; the best beam is the first maximum."""
    B, T, _ = parents.shape
    beam = _first_max(scores)[:, None]  # [B, 1]
    best_score = scores.gather(1, beam)[:, 0]
    sym_seq = torch.empty((B, T), dtype=torch.int64, device=parents.device)
    for t in range(T - 1, -1, -1):
        sym_seq[:, t] = syms[:, t].gather(1, beam)[:, 0]
        beam = parents[:, t].gather(1, beam).long()
    keep = sym_seq >= 0
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    lengths = keep.sum(dim=1)
    mask = torch.arange(T, device=parents.device)[None, :] < lengths[:, None]
    ids = torch.where(mask, sym_seq.gather(1, order), 0)
    frames = torch.where(mask, order, 0)
    return ids, frames, lengths, best_score


def _beam_scan_batch_compact(logits, lengths, beam_width, blank_id, **lm):
    """Batched beam and backtrace on the logits' device: [B, T, V] ->
    (ids [B, T], frames [B, T], lengths [B], scores [B]); the tapes stay on
    the device."""
    parents, syms, scores = _beam_scan_batch(logits, lengths, beam_width,
                                             blank_id, **lm)
    return _device_backtrace(parents, syms, scores)


def _backtrace(parents, syms, scores, beam=None, with_frames=False):
    """Host reverse walk of one utterance's tape (numpy) for ``beam`` (the
    first best by default); with ``with_frames`` also the tape frame at
    which each symbol entered the prefix."""
    best = int(np.argmax(scores)) if beam is None else beam
    seq = []
    frames = []
    beam = best
    for t in range(parents.shape[0] - 1, -1, -1):
        if syms[t, beam] >= 0:
            seq.append(int(syms[t, beam]))
            frames.append(t)
        beam = int(parents[t, beam])
    seq.reverse()
    frames.reverse()
    if with_frames:
        return seq, float(scores[best]), frames
    return seq, float(scores[best])


def _prepare(logits, logit_lengths, blank_id, topk_approx):
    _check_topk(topk_approx)
    logits = torch.as_tensor(logits)
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    lengths = torch.as_tensor(np.asarray(logit_lengths, np.int64)
                              if not torch.is_tensor(logit_lengths)
                              else logit_lengths).to(logits.device)
    return logits, lengths, blank_id


def ctc_beam_search_batch(logits, logit_lengths, beam_width=100,
                          blank_id=None, lm=None, with_frames=False,
                          topk_approx=None):
    """Decode a batch on the logits' device.

    logits [B, T, V] (a tensor, or numpy for the CPU), logit_lengths [B]
    -> list of (ids, score) per utterance, (ids, score, frames) with
    ``with_frames``. ``lm``: optional (NGramLM, weight, bonus) shallow
    fusion, shared across the batch."""
    logits, lengths, blank_id = _prepare(logits, logit_lengths, blank_id,
                                         topk_approx)
    with torch.inference_mode():
        ids, frames, lengths, scores = _beam_scan_batch_compact(
            logits, lengths, beam_width, blank_id,
            **lm_fusion_args(lm, logits.shape[-1], logits.device),
        )
        ids, frames = ids.cpu().numpy(), frames.cpu().numpy()
        lengths, scores = lengths.cpu().numpy(), scores.cpu().numpy()
    out = []
    for b in range(logits.shape[0]):
        n = int(lengths[b])
        seq = [int(x) for x in ids[b, :n]]
        if with_frames:
            out.append((seq, float(scores[b]),
                        [int(x) for x in frames[b, :n]]))
        else:
            out.append((seq, float(scores[b])))
    return out


def ctc_beam_search_nbest(logits, logit_lengths, beam_width=100,
                          blank_id=None, lm=None, top_paths=4,
                          topk_approx=None):
    """N-best batched decode from one beam scan: per utterance up to
    ``top_paths`` (ids, score, frames) triples, best first, deduplicated by
    id sequence. The tapes are walked on the host, as in JAX."""
    logits, lengths, blank_id = _prepare(logits, logit_lengths, blank_id,
                                         topk_approx)
    with torch.inference_mode():
        parents, syms, scores = _beam_scan_batch(
            logits, lengths, beam_width, blank_id,
            **lm_fusion_args(lm, logits.shape[-1], logits.device),
        )
        parents, syms = parents.cpu().numpy(), syms.cpu().numpy()
        scores = scores.cpu().numpy()
    out = []
    for b in range(logits.shape[0]):
        order = np.argsort(-scores[b])
        hyps, seen = [], set()
        for beam in order:
            if scores[b][beam] <= NEG / 2:
                break  # dead beams below
            ids, score, frames = _backtrace(
                parents[b], syms[b], scores[b], beam=int(beam),
                with_frames=True,
            )
            key = tuple(ids)
            if key in seen:
                continue
            seen.add(key)
            hyps.append((ids, score, frames))
            if len(hyps) >= top_paths:
                break
        out.append(hyps)
    return out
