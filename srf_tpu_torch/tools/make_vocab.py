"""Build a vocab file from JSON-lines manifests (the port's own copy of
``srf_tpu/tools/make_vocab.py``).

The reference ships fixed vocabs (egs/data/timit_62.vocab, wsj_31.vocab)
and has no tool to derive one for a new corpus; this emits the same
format the loader expects (``srf_tpu_torch/utils/vocab.load_vocab``): padding symbol
FIRST, corpus symbols sorted by frequency then alphabetically, EOS '$'
and BOS '@' LAST (load_vocab logs critical if '@' is not last —
reference: tfsr/helper/misc_helper.py:78-108). CTC blank is NOT a vocab
entry (it is appended at runtime: blank = len(vocab)).

Run:
    python -m srf_tpu_torch.tools.make_vocab out.vocab train.json [more.json] \
        [--unit char|token] [--min-count N]
"""

import json
import sys
from collections import Counter

PAD = "<PADDING_SYMBOL>"
SPACE = "<SPACE>"
EOS, BOS = "$", "@"


def build_vocab(manifest_paths, unit="char", min_count=1):
    counts = Counter()
    n_utt = 0
    for path in manifest_paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                text = json.loads(line)["text"]
                n_utt += 1
                if unit == "char":
                    for ch in text.strip():
                        counts[SPACE if ch == " " else ch] += 1
                else:
                    for tok in text.strip().split():
                        counts[tok] += 1
    kept = {t: c for t, c in counts.items() if c >= min_count
            and t not in (PAD, EOS, BOS)}
    # frequency-major, alphabetical tiebreak: stable across runs
    symbols = sorted(kept, key=lambda t: (-kept[t], t))
    return [PAD] + symbols + [EOS, BOS], counts, n_utt


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    unit, min_count, pos = "char", 1, []
    it = iter(argv)
    for arg in it:
        if arg.startswith("--unit="):
            unit = arg.split("=", 1)[1]
        elif arg == "--unit":
            unit = next(it, "char")
        elif arg.startswith("--min-count="):
            min_count = int(arg.split("=", 1)[1])
        elif arg == "--min-count":
            min_count = int(next(it, "1"))
        else:
            pos.append(arg)
    if len(pos) < 2 or unit not in ("char", "token"):
        print("usage: python -m srf_tpu_torch.tools.make_vocab <out.vocab> "
              "<manifest.json> [...] [--unit char|token] [--min-count N]")
        return 1
    out_path, manifests = pos[0], pos[1:]
    vocab, counts, n_utt = build_vocab(manifests, unit, min_count)
    with open(out_path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    dropped = len([t for t, c in counts.items() if c < min_count])
    print(
        "wrote %s: %d symbols (+blank at runtime = %d logits) from %d "
        "utterances%s"
        % (out_path, len(vocab), len(vocab) + 1, n_utt,
           ", dropped %d below min-count" % dropped if dropped else "")
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
