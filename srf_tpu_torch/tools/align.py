"""Forced-alignment CLI: align reference transcripts to audio features
(port of ``srf_tpu/tools/align.py``, same flags and output).

Reads the JSON-lines manifests the TFRecord writer consumes (``{"key",
"duration", "text"}``), loads each utterance's features, runs the model
forward through the serving Recognizer (optionally int8), Viterbi-aligns
the reference ids to the logits on the device (``ops/ctc_align.py``) and
writes a CTM-style file: ``<utt_id> 1 <start_s> <dur_s> <token>`` per
token.

Run (trainer-style flags plus the tool's own, and ``--device``):
    python -m srf_tpu_torch.tools.align --config=egs/conf/timit.conf \
        --path-base=... --path-ckpt=.../avg --path-test-json=test.json \
        --tpu-align-out=align.ctm [--device=cuda|cpu]
"""

import json
import sys

import numpy as np

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.ops.ctc_align import ctc_forced_align
from srf_tpu_torch.utils.vocab import get_file_path, get_int_seq


def read_manifest(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def align_utts(recognizer, utts, pad_multiple=128, batch=16):
    """utts: list of (utt_id, feats [T, D], text). Returns a list of
    (utt_id, spans, score) with spans in LOGIT frames (None if the
    transcript cannot be aligned to the utterance)."""
    is_char = recognizer.config.prep_data_unit == "char"
    vocab_map = {t: i for i, t in enumerate(recognizer.vocab)}
    out = []
    for lo in range(0, len(utts), batch):
        chunk = utts[lo: lo + batch]
        labels = [
            get_int_seq(text, is_char=is_char, vocab=vocab_map)
            for _, _, text in chunk
        ]
        feats, lengths = recognizer.pad([f for _, f, _ in chunk],
                                        pad_multiple)
        logits = recognizer.forward(feats, lengths)
        dec_lens = np.maximum(lengths // recognizer.in_len_div, 1)
        max_l = max((len(y) for y in labels), default=1) or 1
        lab = np.zeros((len(chunk), max_l), np.int32)
        lab_lens = np.zeros((len(chunk),), np.int32)
        for i, y in enumerate(labels):
            lab[i, : len(y)] = y
            lab_lens[i] = len(y)
        aligned = ctc_forced_align(
            logits, dec_lens, lab, lab_lens, blank_id=recognizer.blank_id
        )
        for (utt_id, _, _), (spans, score) in zip(chunk, aligned):
            out.append((utt_id, spans, score))
    return out


def write_ctm(out, results, recognizer, channel="1"):
    """CTM lines: utt channel start_s dur_s token score."""
    shift = 0.01 * recognizer.in_len_div
    n_tok = 0
    for utt_id, spans, _score in results:
        if spans is None:
            continue
        for span in spans:
            tok = recognizer.vocab[span["id"]]
            out.write("%s %s %.3f %.3f %s\n" % (
                utt_id, channel, span["start"] * shift,
                (span["end"] - span["start"]) * shift, tok,
            ))
            n_tok += 1
    return n_tok


def main(argv=None):
    logger = Logger(name="align", level=Logger.INFO).logger
    argv = list(argv if argv is not None else sys.argv)
    out_path, manifest_flag, extra = None, "test", []
    it = iter(argv[1:])
    for arg in it:
        if arg == "--tpu-align-out" or arg.startswith("--tpu-align-out="):
            out_path = (arg.split("=", 1)[1] if "=" in arg
                        else next(it, None))
            if not out_path:
                raise SystemExit("--tpu-align-out requires a value")
        elif arg.startswith("--tpu-align-split="):
            manifest_flag = arg.split("=", 1)[1]
        else:
            extra.append(arg)
    if not out_path:
        raise SystemExit("--tpu-align-out=<file.ctm> is required")
    config = ParseOption([argv[0]] + extra, logger).args

    from srf_tpu_torch.serve import Recognizer

    recognizer = Recognizer(config, logger=logger)
    manifest = get_file_path(
        config.path_base,
        getattr(config, "path_%s_json" % manifest_flag),
    )
    utts = []
    for spec in read_manifest(manifest):
        key = spec["key"]
        if config.decoding_from_npy:
            npy = get_file_path(config.path_base, key)
        else:
            npy = get_file_path(
                config.path_base, key + "." + str(config.feat_type) + ".npy"
            )
        utts.append((key, np.load(npy), spec["text"]))
    logger.info("aligning %d utterances from %s", len(utts), manifest)
    results = align_utts(recognizer, utts)
    failed = [u for u, s, _ in results if s is None]
    with open(out_path, "w") as f:
        n_tok = write_ctm(f, results, recognizer)
    logger.info(
        "wrote %s: %d tokens across %d/%d utterances%s", out_path, n_tok,
        len(results) - len(failed), len(results),
        (" (unalignable: %s)" % ", ".join(failed[:5])) if failed else "",
    )


if __name__ == "__main__":
    main()
