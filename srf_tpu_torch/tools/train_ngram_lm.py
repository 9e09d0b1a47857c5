"""Train a shallow-fusion n-gram LM from training transcripts (the port's
own copy of ``srf_tpu/tools/train_ngram_lm.py``).

CLI companion to ops/ngram_lm.py: reads the same JSON-lines manifests the
TFRecord writer consumes (``{"key", "duration", "text"}`` — reference
format: egs/data/sample.json:1), tokenizes with the same vocab + unit
rules as training targets (utils/vocab.get_int_seq; char vs token chosen
by --prep-data-unit, matching reference save_speech_data.py:72), estimates
a Witten-Bell interpolated n-gram over the label ids, and writes the
dense-table .npz that ``--tpu-lm-path`` loads at decode/serving time.

The reference has no language model at all; the JAX package added it, and
this writes the same ``.npz`` as its tool.

Run (flags shared with the trainers, plus --tpu-lm-*):
    python -m srf_tpu_torch.tools.train_ngram_lm --config=egs/conf/timit.conf \
        --path-base=... --path-train-json=... --tpu-lm-out=lm.npz \
        --tpu-lm-order=3
"""

import json
import sys

from srf_tpu_torch.config.logger import Logger
from srf_tpu_torch.config.options import ParseOption
from srf_tpu_torch.ops.ngram_lm import train_ngram
from srf_tpu_torch.utils.vocab import get_file_path, get_int_seq, load_vocab


def read_manifest_texts(path):
    """Yield the text field of every JSON-lines manifest record."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            yield json.loads(line)["text"]


def build_lm(config, logger, manifest_paths, order):
    _, vocab, dec_in_dim, _ = load_vocab(
        get_file_path(config.path_base, config.path_vocab), logger
    )
    is_char = config.prep_data_unit == "char"
    seqs = []
    for path in manifest_paths:
        for text in read_manifest_texts(path):
            seqs.append(get_int_seq(text, is_char=is_char, vocab=vocab))
    if not seqs:
        raise SystemExit("no transcripts found in: %s" % manifest_paths)
    lm = train_ngram(seqs, vocab_size=dec_in_dim, order=order)
    logger.info(
        "trained %d-gram over %d symbols from %d transcripts "
        "(train perplexity %.2f)",
        order, dec_in_dim, len(seqs), lm.perplexity(seqs),
    )
    return lm


def main(argv=None):
    logger = Logger(name="train_ngram_lm", level=Logger.INFO).logger
    argv = list(argv if argv is not None else sys.argv)
    # tool-local flags (not part of the shared registry)
    out_path, order, extra = None, 3, []
    it = iter(argv[1:])
    for arg in it:
        if arg == "--tpu-lm-out" or arg.startswith("--tpu-lm-out="):
            out_path = (arg.split("=", 1)[1] if "=" in arg
                        else next(it, None))
            if not out_path:
                raise SystemExit("--tpu-lm-out requires a value")
        elif arg == "--tpu-lm-order" or arg.startswith("--tpu-lm-order="):
            val = arg.split("=", 1)[1] if "=" in arg else next(it, None)
            if not val:
                raise SystemExit("--tpu-lm-order requires a value")
            order = int(val)
        else:
            extra.append(arg)
    if not out_path:
        raise SystemExit("--tpu-lm-out=<lm.npz> is required")
    config = ParseOption([argv[0]] + extra, logger).args
    manifest = get_file_path(config.path_base, config.path_train_json)
    lm = build_lm(config, logger, [manifest], order)
    lm.save(out_path)
    logger.info("wrote %s", out_path)


if __name__ == "__main__":
    main()
