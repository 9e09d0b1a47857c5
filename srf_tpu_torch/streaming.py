"""Streaming SRF inference: chunked forward with carried recurrence state
(port of ``srf_tpu/streaming.py``).

SDR needs one routing iteration per timestep, so the SRF streams: the only
unbounded state is each capsule layer's previous output capsules (the SDR
carry) plus bounded window context.

Exactness contract: for a full utterance fed through ``push``/``flush``,
the emitted logits equal the batch model's logits on every valid frame
(``tests/test_torch_streaming.py``), because each stage only ever reads:

- the conv front end: a raw-frame window with enough margin to cover its
  receptive field (overlap-and-discard; windows start at multiples of the
  subsampling, so the SAME-padding conv grids of window and whole
  utterance are the same),
- each capsule layer: its previous layer's outputs in [t-lpad, t+rpad]
  (carried context) and its own carry,
- warm-up frames (t < 0) are zeroed by a step mask, as the batch model's
  window zero padding does; the utterance's tail reproduces the batch
  model's masked front-end frames by running zero-padded raw frames with
  the true length's masks at flush.

On the card each layer's SDR is K1 with an initial carry and a step mask
(``routing_cuda.sequential_routing_stream``), 2 launches a layer a step.

Algorithmic latency: ``2*div + L*rpad*div`` raw frames (canonical
SRF-TIMIT: 8 + 7*1*4 = 36 frames = 360 ms).

Both decoders stream. Greedy partials come from ``push``. With
``beam_width`` the device beam (``ops/ctc_beam.py``, the same frame step
as the offline beam) advances inside each step on the logits while they
are on the device, and only the [K] argmax ids come to the host; the
beam's state and backpointer tape are carried across chunks and
``flush`` walks the tape. The streamed beam equals the offline beam on the
whole utterance.
"""

import bisect

import numpy as np
import torch

from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.ops.ctc_beam import (
    _backtrace, beam_chunk_step, beam_init, lm_fusion_args,
)
from srf_tpu_torch.ops.ctc_decode import beam_search_batch
from srf_tpu_torch.ops.pos_enc import get_pos_enc

# the streamed beam's bound while the stream is open (no frame is past it)
_OPEN = 2**30


def _model_device(model):
    return next(model.parameters()).device


class StreamingTranscriber:
    """Chunked inference session over a SequenceRouter in eval mode.

    Args:
        model: the SequenceRouter (SDR or DR), with its weights, in eval
            mode, on the device the session runs on.
        blank_id: CTC blank (= vocab size; blank-last).
        chunk: emission granularity in post-subsample frames (chunk * div
            raw frames arrive per compute step).
        beam_width: if set, also run the frame-synchronous beam over the
            emitted logits as they stream (carried state, advanced inside
            each step); ``hypothesis()`` returns the current best beam and
            ``flush()`` the final one.
        lm: optional (ngram_lm.NGramLM, weight, bonus): shallow fusion on
            the streamed beam (the per-beam LM context rides the carried
            state, so streamed == offline fused decode) and on
            ``flush(beam_width=N)``'s offline rescore.
    """

    def __init__(self, model, blank_id, chunk=8, beam_width=None, lm=None):
        if not isinstance(model, SequenceRouter):
            raise TypeError("streaming supports the SRF SequenceRouter")
        if chunk < 3:
            raise ValueError("chunk must be >= 3 post frames")
        self.model = model
        self.device = _model_device(model)
        self.blank_id = blank_id
        self.beam_width = beam_width
        self.lm = lm
        self._lm_kwargs = lm_fusion_args(lm, model.class_n, self.device)
        self._lm_ctx0 = self._lm_kwargs.pop("lm_ctx0", 0)
        self.div = model.stride ** model.conv_layer_num
        self.K = chunk
        # raw window for post-frames [t0, t0+K): [div*t0 - lmargin,
        # div*(t0+K) + rmargin); the margins cover the front end's
        # receptive field, and window starts stay multiples of div
        lm_posts, rm_posts = model.stream_margin_posts()
        self.lmargin = lm_posts * self.div
        self.rmargin = rm_posts * self.div
        self.win = self.div * self.K + self.lmargin + self.rmargin
        # with the streamed beam on, the beam chunk and the greedy argmax
        # run on the step's logits while they are on the device
        self._fused = bool(beam_width)
        self.reset()

    def reset(self):
        model = self.model
        self._raw = np.zeros((0, model.feat_dim), np.float32)
        self._raw_base = 0  # absolute index of self._raw[0]
        self._pushed = 0
        self._fe_blocks = 0  # next front-end block index
        window_ctx = model.lpad + model.rpad
        self._bufs, self._vprev = [], []
        prev_n, prev_d = model.caps_primary_num, model.caps_primary_dim
        for _, out_n, out_d, _ in model.layer_shapes():
            self._bufs.append(torch.zeros((1, window_ctx, prev_n, prev_d),
                                          device=self.device))
            self._vprev.append(torch.zeros((1, out_n, out_d),
                                           device=self.device))
            prev_n, prev_d = out_n, out_d
        self._logit_frames = 0  # emitted final-layer frames (valid, >= 0)
        self._logits = []
        self._argmax = []  # fused mode: per-block greedy ids (lazy-fetched)
        self._logit_ends = []  # cumulative block end offsets (bisect)
        self._prev_id = self.blank_id
        self._decoded_frames = 0
        self._tokens = []
        self._token_frames = []  # emission frame per greedy token
        self._trailing_blanks = 0  # consecutive argmax-blank frames at tail
        self._segment_start_frame = 0  # first logit frame of open segment
        self._segment_token_start = 0  # index into _tokens for the segment
        if self.beam_width:
            self._beam_frames = 0  # frames the beam has consumed
            self._beam_reset()

    def _beam_reset(self):
        self._beam_state = beam_init(self.beam_width, self._lm_ctx0,
                                     with_lm=self.lm is not None,
                                     device=self.device)
        self._beam_tape = []  # (parents, syms) [n, W] blocks, frame-aligned
        self._beam_tape_base = self._beam_frames
        self._beam_scores = None

    # ------------------------------------------------------------------ io

    def _append_raw(self, frames):
        """Validate and buffer raw frames, dropping rows no future window
        can read (before the next block's window start), so session memory
        and per-push copying stay bounded for arbitrarily long streams."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.model.feat_dim:
            raise ValueError("expected [n, %d] features" % self.model.feat_dim)
        keep_from = self._win_start(self._fe_blocks * self.K)
        drop = keep_from - self._raw_base
        if drop > 0:
            self._raw = self._raw[drop:]
            self._raw_base = keep_from
        self._raw = np.concatenate([self._raw, frames], axis=0)
        self._pushed += frames.shape[0]

    def push(self, frames):
        """Feed raw feature frames [n, feat_dim]; returns newly decoded ids."""
        self._append_raw(frames)
        start = len(self._tokens)
        while self._fe_ready():
            self._advance(true_len=None)
        self._decode_available(limit=None)
        if self.beam_width:
            self._beam_advance(limit=None)
        return self._tokens[start:]

    def flush(self, beam_width=None):
        """End of utterance: drain the cascade, return the remaining ids.

        With the streamed beam on (``beam_width`` at construction) returns
        the final ``(ids, score)`` hypothesis, equal to the offline device
        beam on the whole utterance. ``beam_width`` > 1 as an argument
        instead rescores the whole utterance offline over the accumulated
        logits (the host beam; streamed partials stay greedy) and returns
        its ids.
        """
        start = len(self._tokens)
        t_true = self._pushed
        t_ceil = -(-t_true // self.div)
        # the last layer needs front-end frames up to t_ceil-1 + L*rpad
        need_fe = t_ceil + self.model.enc_num * self.model.rpad
        while self._fe_blocks * self.K < need_fe:
            self._advance(true_len=t_true)
        t_dec = t_true // self.div
        if beam_width and beam_width > 1:
            self._decode_available(limit=t_dec)  # keep greedy state coherent
            return beam_search_batch(self.logits[None], [t_dec], beam_width,
                                     self.blank_id, lm=self.lm)[0]
        self._decode_available(limit=t_dec)
        if self.beam_width:
            self._beam_advance(limit=t_dec)
            return self.hypothesis()
        return self._tokens[start:]

    def hypothesis(self, with_frames=False):
        """Current best streamed-beam hypothesis ``(ids, score)``, or
        ``(ids, score, frames)`` with ``with_frames`` (per-symbol emission
        logit-frame indices). Walks the accumulated tape: the best path may
        revise earlier output, which is why ``push`` emits greedy
        partials."""
        if not self._beam_tape:
            return ([], 0.0, []) if with_frames else ([], 0.0)
        # the tape blocks stay on the device until here
        parents = torch.cat([p for p, _ in self._beam_tape]).cpu().numpy()
        syms = torch.cat([s for _, s in self._beam_tape]).cpu().numpy()
        out = _backtrace(parents, syms, self._beam_scores.cpu().numpy(),
                         with_frames=with_frames)
        if with_frames:
            ids, score, frames = out
            return ids, score, [f + self._beam_tape_base for f in frames]
        return out

    @property
    def token_frames(self):
        """Emission logit-frame index of every greedy token emitted so far
        (parallel to the accumulated ``push`` outputs)."""
        return list(self._token_frames)

    # ------------------------------------------------------- endpointing

    @property
    def trailing_blank_frames(self):
        """Consecutive decoded frames at the stream's tail whose argmax is
        blank: the end-of-speech signal (CTC models emit blank through
        silence). Kept by the greedy decode state, which runs in every
        session."""
        return self._trailing_blanks

    def endpoint_detected(self, min_blank_frames):
        """True when the open segment has emitted at least one token and
        the tail shows ``min_blank_frames`` consecutive blank frames."""
        return (
            len(self._tokens) > self._segment_token_start
            and self._trailing_blanks >= int(min_blank_frames)
        )

    def finalize_segment(self):
        """Close the open segment and reset the decoder for the next one.

        Returns {ids, frames, start_frame, end_frame}: with the streamed
        beam on, the segment's beam hypothesis (and ``score``), greedy
        tokens otherwise. The acoustic state (front-end buffers, SDR
        carries) is untouched; only the decode state restarts, so
        arbitrarily long audio decodes in bounded memory. Boundaries land
        in silence, where restarting the CTC prefix search is exact."""
        end = self._decoded_frames
        seg = {"start_frame": self._segment_start_frame, "end_frame": end}
        if self.beam_width:
            # catch the beam up to the greedy decode position (not to
            # _logit_frames: after flush the logits past the true length
            # are invalid and must never enter the beam)
            self._beam_advance(limit=end)
            ids, score, frames = self.hypothesis(with_frames=True)
            seg.update(ids=ids, frames=frames, score=score)
            self._beam_reset()
        else:
            start = self._segment_token_start
            seg.update(ids=list(self._tokens[start:]),
                       frames=list(self._token_frames[start:]))
        self._segment_token_start = len(self._tokens)
        self._segment_start_frame = end
        self._trailing_blanks = 0
        self._prev_id = self.blank_id  # no collapse across the boundary
        return seg

    def _beam_advance(self, limit):
        """Advance the carried beam over logit frames not yet consumed, in
        K-frame zero-padded blocks. In fused mode the beam advances inside
        each ``_advance`` block, so this finds it caught up; it works only
        when logits are fed in from outside the model path (tests inject
        blocks directly)."""
        total = self._logit_frames if limit is None else min(
            self._logit_frames, limit)
        while self._beam_frames < total:
            lo = self._beam_frames
            hi = min(lo + self.K, total)
            block = np.zeros((1, self.K, self.model.class_n), np.float32)
            block[0, : hi - lo] = self.logits_slice(lo, hi)
            with torch.inference_mode():
                self._beam_state, parents, syms, scores = beam_chunk_step(
                    self._beam_state, torch.from_numpy(block).to(self.device),
                    lo, [hi], self.blank_id, **self._lm_kwargs)
            self._beam_tape.append((parents[0, : hi - lo],
                                    syms[0, : hi - lo]))
            self._beam_scores = scores[0]
            self._beam_frames = hi

    @property
    def logits(self):
        """Accumulated final logits [frames, class_n] (valid frames only),
        the whole concatenation: for whole-utterance readers (the offline
        rescore at flush, tests); incremental readers use
        ``logits_slice``."""
        if not self._logits:
            return np.zeros((0, self.model.class_n), np.float32)
        return self.logits_slice(0, self._logit_frames)

    def _block_slice(self, blocks, lo, hi, out):
        """Copy rows [lo, hi) of the concatenation of ``blocks`` into
        ``out`` through the ``_logit_ends`` cumulative offsets (logits and
        argmax-id blocks are appended in lockstep); the first block comes
        from a bisect, so a call costs O(log blocks + slice). A block still
        on the device comes to the host on first touch and its host copy
        replaces it, so each block is fetched at most once."""
        start = bisect.bisect_right(self._logit_ends, lo)
        offset = self._logit_ends[start - 1] if start else 0
        for k in range(start, len(blocks)):
            block = blocks[k]
            if torch.is_tensor(block):
                block = block.cpu().numpy()
                blocks[k] = block
            n = block.shape[0]
            b_lo, b_hi = max(lo - offset, 0), min(hi - offset, n)
            if b_lo < b_hi:
                out[offset + b_lo - lo : offset + b_hi - lo] = (
                    block[b_lo:b_hi])
            offset += n
            if offset >= hi:
                break
        return out

    def logits_slice(self, lo, hi):
        """Rows [lo, hi) of the accumulated logits without concatenating
        the whole history."""
        return self._block_slice(
            self._logits, lo, hi,
            np.zeros((hi - lo, self.model.class_n), np.float32))

    # ------------------------------------------------------------- internal

    def _win_start(self, t0):
        # early blocks pin the window to raw 0 so the conv SAME zero
        # padding at the utterance's start is reproduced exactly
        return max(0, self.div * t0 - self.lmargin)

    def _fe_ready(self):
        start = self._win_start(self._fe_blocks * self.K)
        return self._pushed >= start + self.win

    def _raw_window(self, t0):
        s = self._win_start(t0)
        out = np.zeros((self.win, self.model.feat_dim), np.float32)
        rel_s = s - self._raw_base
        hi = min(rel_s + self.win, self._raw.shape[0])
        if hi > rel_s:
            out[: hi - rel_s] = self._raw[rel_s:hi]
        return out[None], s

    def _advance_inputs(self, true_len):
        """Host-side inputs of the next block: (window [1, win, feat],
        length, lpost, offsets [L], pos); split from the device step so
        that StreamingPool can batch many sessions' steps."""
        model = self.model
        t0 = self._fe_blocks * self.K
        window, s = self._raw_window(t0)
        if true_len is None:
            length = self.win
        else:
            length = min(max(true_len - s, 0), self.win)
        pos = None
        if model.caps_type == "einsum":
            post0 = s // self.div
            pos = get_pos_enc(post0 + self.win // self.div,
                              model.caps_primary_num,
                              device=self.device)[post0:]
        lpost = t0 - s // self.div
        offsets = np.asarray([t0 - (i + 1) * model.rpad
                              for i in range(model.enc_num)], np.int64)
        return window, length, lpost, offsets, pos

    def _block_offset(self):
        """Global index of the final layer's first frame in the next
        block."""
        return self._fe_blocks * self.K - self.model.enc_num * self.model.rpad

    def _advance_commit(self, logits_np):
        """Book-keep one block's host logits [K, class_n]."""
        offset = self._block_offset()
        self._fe_blocks += 1
        lo = max(0, -offset)  # skip warm-up frames
        if lo < self.K:
            self._logits.append(logits_np[lo:])
            self._logit_ends.append(self._logit_frames + self.K - lo)
            self._logit_frames += self.K - lo

    def _advance(self, true_len):
        """Compute one front-end block and cascade it through the layers;
        in fused mode the beam chunk and the greedy argmax follow on the
        device, and nothing comes to the host here."""
        window, length, lpost, offsets, pos = self._advance_inputs(true_len)
        with torch.inference_mode():
            logits, self._bufs, self._vprev = self.model.stream_step(
                torch.from_numpy(window).to(self.device),
                torch.tensor([length], device=self.device), [lpost],
                self._bufs, self._vprev, offsets[None],
                None if pos is None else pos[None])
            if not self._fused:
                self._advance_commit(logits[0].cpu().numpy())
                return
            offset = self._block_offset()
            bound = _OPEN if true_len is None else true_len // self.div
            self._beam_state, parents, syms, scores = beam_chunk_step(
                self._beam_state, logits, offset, [bound], self.blank_id,
                **self._lm_kwargs)
        self._commit_fused(logits[0], logits[0].argmax(dim=-1), parents[0],
                           syms[0], scores[0], offset, bound)

    def _commit_fused(self, blk, ids, parents, syms, scores, offset, bound):
        """Book-keep one fused block; what is appended stays on the device
        (logits for the offline rescore, argmax ids for greedy partials,
        tape rows for the beam's backtrace)."""
        self._fe_blocks += 1
        lo = max(0, -offset)  # warm-up rows are never emitted
        if lo < self.K:
            self._logits.append(blk[lo:])
            self._argmax.append(ids[lo:])
            self._logit_ends.append(self._logit_frames + self.K - lo)
            self._logit_frames += self.K - lo
            self._beam_tape.append((parents[lo:], syms[lo:]))
            self._beam_scores = scores
            self._beam_frames = min(max(0, offset + self.K), bound)

    def _ids_slice(self, lo, hi):
        """Rows [lo, hi) of the accumulated greedy argmax ids (fused
        mode), fetched once per block."""
        return self._block_slice(self._argmax, lo, hi,
                                 np.zeros((hi - lo,), np.int64))

    def _decode_available(self, limit):
        total = self._logit_frames if limit is None else min(
            self._logit_frames, limit)
        if total <= self._decoded_frames:
            return
        if self._fused and self._logit_ends and len(self._argmax) == len(
                self._logits):
            ids = self._ids_slice(self._decoded_frames, total)
        else:
            # non-fused, or logits injected from outside the model path
            # (tests), where no fused argmax block exists
            ids = np.argmax(self.logits_slice(self._decoded_frames, total),
                            axis=-1)
        for k, frame_id in enumerate(ids):
            frame_id = int(frame_id)
            if frame_id != self.blank_id and frame_id != self._prev_id:
                self._tokens.append(frame_id)
                self._token_frames.append(self._decoded_frames + k)
            if frame_id == self.blank_id:
                self._trailing_blanks += 1
            else:
                self._trailing_blanks = 0
            self._prev_id = frame_id
        self._decoded_frames = total


class StreamingPool:
    """N concurrent streaming sessions, one batched step per tick.

    ``push`` only buffers on the host; ``step`` advances every session with
    a ready block through one batched ``stream_step`` (the slots' carries
    stacked into B rows, each row with its own window position, warm-up
    mask and, for the einsum flavor, positional-encoding slice) and, with
    ``beam_width``, one batched beam chunk (each row with its own start
    frame); the new carries are split back into the sessions. Results equal
    standalone ``StreamingTranscriber`` sessions', and ``flush(slot)``
    drains that session's tail through its own single-session path.
    Ticks whose ready set is smaller than ``slots`` are padded with copies
    of the first ready row (discarded), so every tick has one shape.
    """

    def __init__(self, model, blank_id, slots, chunk=8, beam_width=None,
                 lm=None):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.sessions = [
            StreamingTranscriber(model, blank_id, chunk=chunk,
                                 beam_width=beam_width, lm=lm)
            for _ in range(slots)
        ]
        self.model = model
        self.slots = slots
        self.beam_width = beam_width

    def push(self, slot, frames):
        """Buffer raw feature frames [n, feat_dim] for ``slot`` (host only;
        device work happens in ``step``)."""
        self.sessions[slot]._append_raw(frames)

    def step(self):
        """One tick: advance every session with a ready block in one
        batched step. Returns {slot: newly decoded greedy ids}."""
        ready = [i for i, s in enumerate(self.sessions) if s._fe_ready()]
        if not ready:
            return {}
        idx = ready + [ready[0]] * (self.slots - len(ready))
        sessions = [self.sessions[i] for i in idx]
        first = sessions[0]
        device = first.device
        preps = [s._advance_inputs(None) for s in sessions]
        pos = None
        if self.model.caps_type == "einsum":
            pos = torch.stack([p[4] for p in preps])
        n_layers = len(first._bufs)
        with torch.inference_mode():
            logits, new_bufs, new_vprev = self.model.stream_step(
                torch.from_numpy(np.concatenate([p[0] for p in preps])).to(
                    device),
                torch.tensor([p[1] for p in preps], device=device),
                [p[2] for p in preps],
                [torch.cat([s._bufs[l] for s in sessions])
                 for l in range(n_layers)],
                [torch.cat([s._vprev[l] for s in sessions])
                 for l in range(n_layers)],
                np.stack([p[3] for p in preps]), pos)
            if self.beam_width:
                # each row's own first frame: the slots stand apart
                t0s = [s._block_offset() for s in sessions]
                states = {key: torch.cat([s._beam_state[key]
                                          for s in sessions])
                          for key in first._beam_state}
                nstate, parents, syms, scores = beam_chunk_step(
                    states, logits, torch.tensor(t0s, device=device),
                    [_OPEN] * self.slots, first.blank_id,
                    **first._lm_kwargs)
                # the tick's one host sync
                ids_np = logits.argmax(dim=-1).cpu().numpy()
            else:
                logits_np = logits.cpu().numpy()  # the tick's one host sync
        out = {}
        for row, i in enumerate(ready):
            s = self.sessions[i]
            s._bufs = [b[row : row + 1] for b in new_bufs]
            s._vprev = [v[row : row + 1] for v in new_vprev]
            start = len(s._tokens)
            if self.beam_width:
                s._beam_state = {key: value[row : row + 1]
                                 for key, value in nstate.items()}
                s._commit_fused(logits[row], ids_np[row], parents[row],
                                syms[row], scores[row], t0s[row], _OPEN)
            else:
                s._advance_commit(logits_np[row])
            s._decode_available(limit=None)
            out[i] = s._tokens[start:]
        return out

    def drain(self):
        """Tick until no session has a ready block."""
        while self.step():
            pass

    def hypothesis(self, slot, with_frames=False):
        """Current best streamed-beam hypothesis for ``slot``."""
        return self.sessions[slot].hypothesis(with_frames=with_frames)

    def flush(self, slot):
        """End of utterance for ``slot``: drain its tail through the
        session's own path (other slots are untouched). Returns the final
        hypothesis ((ids, score) with the beam, the remaining ids
        otherwise) and resets the slot for reuse."""
        session = self.sessions[slot]
        result = session.flush()
        session.reset()
        return result
