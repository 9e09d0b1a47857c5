"""Serving/inference API (port of ``srf_tpu/serve.py``).

Loads weights, pads a batch of feature matrices to a multiple of
``pad_multiple`` frames, runs the model's forward, decodes (greedy, or the
CTC beam on the device with optional n-best and n-gram shallow fusion,
``--tpu-lm-path``) and returns ids, mapped text (TIMIT 61->39 or
characters), scores, confidences and timestamps, with the same keys as the
JAX Recognizer.

Every family of ``models/registry.py`` is served (SRF, CNN, (B)LSTM, STF).
The forward is the model's with no other argument, as the JAX Recognizer
applies it (``srf_tpu/serve.py`` ``_apply``): a served STF gets no padding
bias and no penalty board and attends over the padded frames, so its
logits differ from ``trainer_tf``'s decode of the same weights (F17 in
ROADMAP.md; kept as the reference's behaviour).

Weights: a ``state_dict`` given directly, a ``.npz`` of the flax tree (see
``convert.py``), ``<path_ckpt>/model.pt`` (a ``torch.save``d state_dict),
or a checkpoint of ``utils/checkpoint.py`` under ``path_ckpt``
(``--path-ckpt-epoch`` N or the latest step); ``reload`` swaps in a newer
checkpoint while serving. ``--tpu-serve-quant=int8`` keeps the weights in
int8 with per-channel scales (``ops/quant.py``), dequantized inside each
forward. SRF models also stream (``streaming_session``,
``streaming_pool``, ``transcribe_long``: ``streaming.py``).
``--tpu-decode-ema`` belongs with EMA training, not ported yet: it raises
``NotImplementedError``.

CLI:
    python -m srf_tpu_torch.serve --config=... --path-base=... \\
        --path-ckpt=... --feats utt1.npy [...] \\
        [--corpus timit|wsj] [--device=cuda|cpu]
    # raw audio in one step (fbank-123 + utterance CMVN front end):
    python -m srf_tpu_torch.serve ... --wav utt1.wav [--wav utt2.wav ...]
    # streaming with greedy partials (SRF models):
    python -m srf_tpu_torch.serve ... --feats utt.npy --stream
    # long-form: stream and segment at silence, timestamped segments:
    python -m srf_tpu_torch.serve ... --feats recording.npy --long
"""

import os
import sys
import threading

import numpy as np
import torch

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.convert import load_npz
from srf_tpu_torch.device import resolve_device
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops.ctc_beam import (
    ctc_beam_search_batch, ctc_beam_search_nbest, lm_on_device,
)
from srf_tpu_torch.ops.ctc_decode import greedy_decode_frames
from srf_tpu_torch.ops.ngram_lm import load_lm_from_config
from srf_tpu_torch.ops.quant import quantize_model, quantized_bytes
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils.checkpoint import (
    CheckpointManager, load_checkpoint, restore_into,
)
from srf_tpu_torch.utils.log2utt import ids_to_utt
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

_LATER = "%s is not ported yet: a later slice of the PyTorch port"


def load_weights(config, model, logger):
    """Load ``model``'s weights from ``config.path_ckpt``: a flax ``.npz``
    file, ``<path_ckpt>/model.pt``, or (when ``--path-ckpt-epoch`` is
    positive or there is no model.pt) a checkpoint through
    ``utils/checkpoint.load_checkpoint``. Returns the checkpoint's step (0
    for a .npz or model.pt)."""
    path_ckpt = config.path_ckpt
    if path_ckpt.endswith(".npz"):
        model.load_state_dict(load_npz(path_ckpt))
        return 0
    path = os.path.join(path_ckpt, "model.pt")
    if os.path.isfile(path) and not (config.path_ckpt_epoch or 0) > 0:
        model.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))
        return 0
    manager, restored, step = load_checkpoint(
        config, logger, TrainState(model=model, optimizer=None),
        params_only=True)
    manager.close()
    if restored is None:
        raise FileNotFoundError(
            "no weights: %s is not a .npz and holds no model.pt and no "
            "checkpoint" % path_ckpt)
    return step


def load_features(config, path, is_wav):
    """One input of the CLIs: a ``.npy`` feature matrix, or a wav file
    through the training front end (fbank-123 and utterance-level CMVN:
    one utterance is its own best statistics at serving time)."""
    if not is_wav:
        return np.load(path)
    if config.feat_dim != 123:
        raise SystemExit("--wav needs a 123-dim fbank model (feat_dim is %d)"
                         % config.feat_dim)
    from srf_tpu_torch.data.features import (
        apply_cmvn, cmvn_stats, extract_fbank123,
    )
    from srf_tpu_torch.tools.extract_features import read_wav

    signal, rate = read_wav(path)
    feats = extract_fbank123(signal, rate)
    return apply_cmvn(feats, *cmvn_stats([feats])).astype(np.float32)


class Recognizer:
    def __init__(self, config, state_dict=None, device=None, logger=None):
        logger = logger or Logger(name="srf_serve", level=Logger.INFO).logger
        self.device = resolve_device(device or getattr(config, "device", None))
        if getattr(config, "tpu_decode_ema", False):
            raise NotImplementedError(_LATER % "--tpu-decode-ema")
        self.config = config
        self._logger = logger
        self.quantized = getattr(config, "tpu_serve_quant", "none") == "int8"
        self.vocab, _, dec_in_dim, _ = load_vocab(
            get_file_path(config.path_base, config.path_vocab), logger
        )
        self.blank_id = dec_in_dim
        model, self.in_len_div = build_model(config, dec_in_dim + 1, logger)
        if state_dict is None:
            step = load_weights(config, model, logger)
        else:
            model.load_state_dict(state_dict)
            step = 0
        # the checkpoint step being served; the model is swapped whole by
        # reload(), so a forward reads one set of weights
        self.step = step
        self.model = self._serving_model(model)
        self._reload_lock = threading.Lock()
        # --tpu-lm-path: shallow-fusion n-gram LM for every beam decode,
        # its table on the device once; the host copy serves the host
        # beam (a streaming flush's offline rescore)
        self.lm_host = load_lm_from_config(config, logger)
        self.lm = lm_on_device(self.lm_host, self.device)

    def _serving_model(self, model):
        """``model`` in eval mode on the device, its weights in int8 with
        per-channel scales under --tpu-serve-quant=int8 (quantized on the
        CPU, so the card and the CPU serve the same int8 weights)."""
        if self.quantized:
            quantize_model(model.cpu())
            q_bytes, f_bytes = quantized_bytes(model)
            self._logger.info(
                "int8 weight quantization: %.1f MB -> %.1f MB resident",
                f_bytes / 1e6, q_bytes / 1e6)
        return model.to(self.device).eval()

    def reload(self, step=None):
        """Swap in a newer checkpoint of ``path_ckpt`` while serving.

        ``step=None`` polls the latest step and swaps only if it is newer
        than ``self.step``; an explicit ``step`` always swaps. The new
        weights go into a new model, assigned in one step: in-flight
        requests finish on the old one, and streaming sessions keep the
        model they were opened on. Returns the new step, or None if nothing
        changed."""
        with self._reload_lock:
            current = self.step
            manager = CheckpointManager(self.config.path_ckpt)
            try:
                if step is None:
                    latest = manager.latest_step()
                    if latest is None or latest <= current:
                        return None
                    step = latest
                model, _ = build_model(self.config, self.blank_id + 1)
                restore_into(TrainState(model=model, optimizer=None),
                             manager.restore(step), params_only=True)
            finally:
                manager.close()
            self.model = self._serving_model(model)
            self.step = int(step)
            self._logger.info("Hot-reloaded checkpoint: step %d -> %d",
                              current, step)
            return self.step

    def streaming_session(self, chunk=8, beam_width=None):
        """Chunked low-latency inference (SRF models): a
        ``streaming.StreamingTranscriber`` on the served model; feed
        features with ``push()``, finish with ``flush()``. ``beam_width``
        turns on the streamed beam (with the configured shallow-fusion LM,
        if any)."""
        from srf_tpu_torch.streaming import StreamingTranscriber

        return StreamingTranscriber(self.model, self.blank_id, chunk=chunk,
                                    beam_width=beam_width, lm=self.lm_host)

    def streaming_pool(self, slots, chunk=8, beam_width=None):
        """N concurrent streaming sessions, one batched step per tick: a
        ``streaming.StreamingPool`` on the served model; buffer with
        ``push(slot, frames)``, advance every live stream with ``step()``,
        finish one with ``flush(slot)`` (the slot is then reusable)."""
        from srf_tpu_torch.streaming import StreamingPool

        return StreamingPool(self.model, self.blank_id, slots=slots,
                             chunk=chunk, beam_width=beam_width,
                             lm=self.lm_host)

    def transcribe_long(self, feats, chunk=8, beam_width=None,
                        endpoint_blanks=25, corpus="timit",
                        push_frames=None, max_segment_s=30.0):
        """Long-form transcription: stream ``feats`` [T, feat_dim] through
        a session, closing a segment at each run of ``endpoint_blanks``
        consecutive blank logit-frames (silence), or at ``max_segment_s``
        of open segment with tokens in it (continuous speech), so decode
        state stays bounded however long the audio.

        Returns a list of segment dicts {ids, text, frames, times,
        start_s, end_s} (and ``score`` with a beam), in stream order.
        """
        feats = np.asarray(feats, np.float32)
        session = self.streaming_session(chunk=chunk, beam_width=beam_width)
        push = push_frames or (chunk * session.div * 4)
        segments = []

        def _close():
            seg = session.finalize_segment()
            if seg["ids"]:
                segments.append(seg)

        shift = 0.01 * self.in_len_div
        max_frames = max(int(max_segment_s / shift), 1)
        for lo in range(0, feats.shape[0], push):
            session.push(feats[lo: lo + push])
            open_frames = (session._decoded_frames
                           - session._segment_start_frame)
            if session.endpoint_detected(endpoint_blanks) or (
                    open_frames >= max_frames
                    and len(session._tokens) > session._segment_token_start):
                _close()
        session.flush()
        _close()
        raw_vocab = [t if t != " " else "<SPACE>" for t in self.vocab]
        return [
            {
                "ids": seg["ids"],
                "text": ids_to_utt(seg["ids"], raw_vocab, corpus),
                "frames": seg["frames"],
                "times": [round(f * shift, 4) for f in seg["frames"]],
                "start_s": round(seg["start_frame"] * shift, 4),
                "end_s": round(seg["end_frame"] * shift, 4),
                **({"score": seg["score"]} if "score" in seg else {}),
            }
            for seg in segments
        ]

    def pad(self, feats_list, pad_multiple=128):
        """list of [T_i, feat_dim] -> (feats [B, W, feat_dim] on the device,
        lengths [B] numpy), W the longest T_i rounded up to pad_multiple."""
        feats_list = [np.asarray(f, np.float32) for f in feats_list]
        feat_dim = self.config.feat_dim
        for i, f in enumerate(feats_list):
            if f.ndim != 2 or f.shape[1] != feat_dim:
                raise ValueError(
                    "request %d: expected [T, %d] features, got %s"
                    % (i, feat_dim, f.shape)
                )
        lengths = np.array([f.shape[0] for f in feats_list], np.int32)
        width = -(-int(lengths.max()) // pad_multiple) * pad_multiple
        padded = np.zeros((len(feats_list), width, feat_dim), np.float32)
        for i, f in enumerate(feats_list):
            padded[i, : f.shape[0]] = f
        return torch.from_numpy(padded).to(self.device), lengths

    def forward(self, feats, lengths):
        """Padded feats [B, W, feat_dim] + lengths -> logits [B, T', V]."""
        with torch.inference_mode():
            return self.model(feats,
                              torch.as_tensor(lengths, device=self.device))

    def transcribe(self, feats, beam_width=None, pad_multiple=128,
                   corpus="timit"):
        """feats: [T, feat_dim] numpy -> (ids, text)."""
        return self.transcribe_batch(
            [feats], beam_width=beam_width, pad_multiple=pad_multiple,
            corpus=corpus,
        )[0]

    def transcribe_batch(self, feats_list, beam_width=None, pad_multiple=128,
                         corpus="timit"):
        """Batch serving: list of [T_i, feat_dim] -> list of (ids, text)."""
        return [
            (d["ids"], d["text"]) for d in self.transcribe_batch_detailed(
                feats_list, beam_width=beam_width,
                pad_multiple=pad_multiple, corpus=corpus,
            )
        ]

    def transcribe_batch_detailed(self, feats_list, beam_width=None,
                                  pad_multiple=128, corpus="timit",
                                  n_best=1):
        """Like transcribe_batch, with per-utterance scoring detail.

        Returns dicts {ids, text, score, avg_logp, confidence, frames,
        times, token_confidences}: ``score`` is the hypothesis log-score —
        for beam decodes the merged-prefix CTC mass of the best beam (plus
        the weighted LM when fusing), for greedy the best-path (Viterbi)
        log-prob of the alignment over the floor(len / in_len_div) decoded
        frames; ``avg_logp`` normalizes it by those frames and
        ``confidence`` is its exp; ``frames`` holds each symbol's emission
        logit-frame (first frame of its run / frame it entered the beam
        prefix), ``times`` its start in seconds (10 ms input frames x the
        subsampling) and ``token_confidences`` the posterior of each symbol
        at its emission frame. ``n_best`` > 1 (beam decodes only) adds that
        many ranked hypotheses under "nbest" from the same beam scan.
        """
        if not feats_list:
            return []
        feats, lengths = self.pad(feats_list, pad_multiple)
        logits = self.forward(feats, lengths)
        dec_lens = np.maximum(lengths // self.in_len_div, 1)
        nbest_lists = None
        with torch.inference_mode():
            logp = torch.log_softmax(logits.float(), dim=-1)
        if beam_width and beam_width > 1:
            if n_best and n_best > 1:
                # one scan serves both the top path and the n-best list
                nbest_lists = ctc_beam_search_nbest(
                    logits, dec_lens, beam_width, self.blank_id,
                    lm=self.lm, top_paths=n_best,
                )
                results = [hyps[0] for hyps in nbest_lists]
            else:
                results = ctc_beam_search_batch(
                    logits, dec_lens, beam_width, self.blank_id,
                    lm=self.lm, with_frames=True,
                )
            decoded = [ids for ids, _, _ in results]
            scores = [score for _, score, _ in results]
            frames = [fr for _, _, fr in results]
        else:
            with torch.inference_mode():
                out, lens, emit = greedy_decode_frames(
                    logits, torch.as_tensor(dec_lens, device=self.device),
                    blank_id=self.blank_id,
                )
                frame_max = logp.max(dim=-1).values.cpu().numpy()
            out, lens = out.cpu().numpy(), lens.cpu().numpy()
            emit = emit.cpu().numpy()
            decoded = [[int(x) for x in out[i, : int(lens[i])]]
                       for i in range(len(feats_list))]
            frames = [[int(x) for x in emit[i, : int(lens[i])]]
                      for i in range(len(feats_list))]
            # best-path (Viterbi) log-prob over the valid frames
            pos = np.arange(frame_max.shape[1])[None, :]
            scores = (frame_max * (pos < dec_lens[:, None])).sum(axis=-1)
        # per-token confidence: logp at each token's (emission frame, symbol)
        max_tok = max((len(ids) for ids in decoded), default=0)
        tok_logp = None
        if max_tok:
            frame_idx = np.zeros((len(decoded), max_tok), np.int64)
            sym_idx = np.zeros((len(decoded), max_tok), np.int64)
            for i, ids in enumerate(decoded):
                frame_idx[i, : len(ids)] = frames[i]
                sym_idx[i, : len(ids)] = ids
            rows = torch.arange(len(decoded), device=self.device)[:, None]
            tok_logp = logp[rows, torch.as_tensor(frame_idx, device=self.device),
                            torch.as_tensor(sym_idx, device=self.device)]
            tok_logp = tok_logp.cpu().numpy()
        raw_vocab = [t if t != " " else "<SPACE>" for t in self.vocab]
        frame_shift_s = 0.01 * self.in_len_div  # 10 ms frames x subsample
        results = []
        for i, ids in enumerate(decoded):
            avg = float(scores[i]) / max(int(dec_lens[i]), 1)
            results.append({
                "ids": ids,
                "text": ids_to_utt(ids, raw_vocab, corpus),
                "score": float(scores[i]),
                "avg_logp": avg,
                "confidence": float(np.exp(min(avg, 0.0))),
                "frames": list(frames[i]),
                "times": [round(f * frame_shift_s, 4) for f in frames[i]],
                "token_confidences": [
                    round(float(np.exp(tok_logp[i, j])), 4)
                    for j in range(len(ids))
                ],
            })
            if nbest_lists is not None:
                results[-1]["nbest"] = [
                    {
                        "ids": h_ids,
                        "text": ids_to_utt(h_ids, raw_vocab, corpus),
                        "score": float(h_score),
                    }
                    for h_ids, h_score, _ in nbest_lists[i]
                ]
        return results


def main(argv=None):
    logger = Logger(name="srf_serve", level=Logger.INFO).logger
    argv = list(argv or sys.argv)
    inputs = []  # (path, is_wav)
    corpus = "timit"
    stream = long_form = False
    filtered = []
    it = iter(argv)
    for arg in it:
        flag = arg.split("=", 1)[0]
        if flag in ("--feats", "--wav"):
            path = arg.split("=", 1)[1] if "=" in arg else next(it, None)
            if path is None:
                raise SystemExit("%s requires a value" % flag)
            inputs.append((path, flag == "--wav"))
        elif arg.startswith("--corpus="):
            corpus = arg.split("=", 1)[1]
        elif arg == "--stream":
            stream = True
        elif arg == "--long":
            long_form = True
        else:
            filtered.append(arg)
    config = ParseOption(filtered, logger, is_print_opts=False).args
    recognizer = Recognizer(config, logger=logger)
    beam = config.decoding_beam_width
    raw_vocab = [t if t != " " else "<SPACE>" for t in recognizer.vocab]
    # .npy inputs first, then wavs, as the JAX CLI orders them
    inputs = ([x for x in inputs if not x[1]] + [x for x in inputs if x[1]])
    batch = []
    for path, is_wav in inputs:
        feats = load_features(config, path, is_wav)
        if long_form:
            for seg in recognizer.transcribe_long(
                    feats, corpus=corpus,
                    beam_width=(beam if beam and beam > 1 else None)):
                print("[%8.2fs - %8.2fs] %s (%s)"
                      % (seg["start_s"], seg["end_s"], seg["text"], path))
        elif stream:
            session = recognizer.streaming_session()
            ids = []
            for start in range(0, feats.shape[0], 50):  # 0.5 s at a time
                new = session.push(feats[start : start + 50])
                if new:
                    print("partial: %s" % ids_to_utt(new, raw_vocab, corpus))
                ids += new
            if beam and beam > 1:
                # greedy partials stream; the flush rescores the whole
                # utterance with the beam
                ids = list(session.flush(beam_width=beam))
            else:
                ids += session.flush()
            print("%s (%s)" % (ids_to_utt(ids, raw_vocab, corpus), path))
        else:
            batch.append((path, feats))
    if batch:
        # whole request list in one forward + one decode
        results = recognizer.transcribe_batch(
            [feats for _, feats in batch], beam_width=beam, corpus=corpus)
        for (path, _), (_, text) in zip(batch, results):
            print("%s (%s)" % (text, path))


if __name__ == "__main__":
    main()
