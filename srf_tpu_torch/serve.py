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
(``--path-ckpt-epoch`` N or the latest step). Streaming, long-form, raw
audio and int8 weights are later slices: they raise
``NotImplementedError``.

CLI:
    python -m srf_tpu_torch.serve --config=... --path-base=... \\
        --path-ckpt=... --feats utt1.npy [...] \\
        [--corpus timit|wsj] [--device=cuda|cpu]
"""

import os
import sys

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
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils.checkpoint import load_checkpoint
from srf_tpu_torch.utils.log2utt import ids_to_utt
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

_LATER = "%s is not ported yet: a later slice of the PyTorch port"


def load_weights(config, model, logger):
    """Load ``model``'s weights from ``config.path_ckpt``: a flax ``.npz``
    file, ``<path_ckpt>/model.pt``, or (when ``--path-ckpt-epoch`` is
    positive or there is no model.pt) a checkpoint through
    ``utils/checkpoint.load_checkpoint``."""
    path_ckpt = config.path_ckpt
    if path_ckpt.endswith(".npz"):
        model.load_state_dict(load_npz(path_ckpt))
        return
    path = os.path.join(path_ckpt, "model.pt")
    if os.path.isfile(path) and not (config.path_ckpt_epoch or 0) > 0:
        model.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))
        return
    manager, restored, _ = load_checkpoint(
        config, logger, TrainState(model=model, optimizer=None),
        params_only=True)
    manager.close()
    if restored is None:
        raise FileNotFoundError(
            "no weights: %s is not a .npz and holds no model.pt and no "
            "checkpoint" % path_ckpt)


class Recognizer:
    def __init__(self, config, state_dict=None, device=None, logger=None):
        logger = logger or Logger(name="srf_serve", level=Logger.INFO).logger
        self.device = resolve_device(device or getattr(config, "device", None))
        if getattr(config, "tpu_serve_quant", "none") == "int8":
            raise NotImplementedError(_LATER % "--tpu-serve-quant=int8")
        if getattr(config, "tpu_decode_ema", False):
            raise NotImplementedError(_LATER % "--tpu-decode-ema")
        self.config = config
        self.vocab, _, dec_in_dim, _ = load_vocab(
            get_file_path(config.path_base, config.path_vocab), logger
        )
        self.blank_id = dec_in_dim
        model, self.in_len_div = build_model(config, dec_in_dim + 1, logger)
        if state_dict is None:
            load_weights(config, model, logger)
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        # --tpu-lm-path: shallow-fusion n-gram LM for every beam decode,
        # its table on the device once
        self.lm = lm_on_device(load_lm_from_config(config, logger),
                               self.device)

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
            return self.model(feats, torch.as_tensor(lengths, device=self.device))

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
    feats_paths = []
    corpus = "timit"
    filtered = []
    it = iter(argv)
    for arg in it:
        if arg == "--feats":
            path = next(it, None)
            if path is None:
                raise SystemExit("--feats requires a value")
            feats_paths.append(path)
        elif arg.startswith("--feats="):
            feats_paths.append(arg.split("=", 1)[1])
        elif arg.startswith("--corpus="):
            corpus = arg.split("=", 1)[1]
        elif arg.split("=", 1)[0] in ("--wav", "--stream", "--long"):
            raise NotImplementedError(_LATER % arg.split("=", 1)[0])
        else:
            filtered.append(arg)
    config = ParseOption(filtered, logger, is_print_opts=False).args
    recognizer = Recognizer(config, logger=logger)
    if feats_paths:
        # whole request list in one forward + one decode
        results = recognizer.transcribe_batch(
            [np.load(path) for path in feats_paths],
            beam_width=config.decoding_beam_width, corpus=corpus,
        )
        for path, (_, text) in zip(feats_paths, results):
            print("%s (%s)" % (text, path))


if __name__ == "__main__":
    main()
