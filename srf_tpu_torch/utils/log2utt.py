"""Decode-log -> sclite .utt converter (the port's own copy of
``srf_tpu/utils/log2utt.py``).

TIMIT: ids -> phones -> 61->39 mapping (reference: tfsr/utils/log2utt.py);
WSJ/char: ids -> chars, ``<SPACE>`` -> ' ' (reference: log2utt_wsj.py).
Reads the two-line scrape format (``UTTID: ["..."]`` + a ``values=[...]``
line) that ``train/loop.run_decoding`` prints.

CLI:
    python -m srf_tpu_torch.utils.log2utt <decode.log> <vocab> [--corpus timit|wsj]
"""

import argparse

from srf_tpu_torch.utils.timit_map import map_phones


def parse_decode_log(lines):
    """Yield (utt_id, [int ids]) pairs from a decode log."""
    status = 0
    utt_id = None
    for line in lines:
        if status == 0:
            if "UTTID" in line:
                utt_id = line.replace('UTTID: ["', "").replace('"]', "").strip()
                status = 1
        elif status == 1:
            if "values" in line:
                value = line.split("[")[2].split("]")[0].strip()
                ids = [int(tok) for tok in value.split() if tok]
                yield utt_id, ids
                status = 0


def ids_to_utt(ids, vocab, corpus):
    if corpus == "timit":
        phones = [vocab[i] for i in ids]
        return " ".join(map_phones(phones))
    # wsj/char: join, <SPACE> -> ' '
    chars = []
    for i in ids:
        token = vocab[i]
        chars.append(" " if token == "<SPACE>" else token)
    return "".join(chars).strip()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("log")
    parser.add_argument("vocab")
    parser.add_argument("--corpus", default="timit", choices=["timit", "wsj"])
    args = parser.parse_args(argv)

    vocab = [line.strip() for line in open(args.vocab)]
    with open(args.log) as f:
        for utt_id, ids in parse_decode_log(f):
            print("%s (%s)" % (ids_to_utt(ids, vocab, args.corpus), utt_id))


if __name__ == "__main__":
    main()
