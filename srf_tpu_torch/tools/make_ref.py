"""CLI: generate sclite reference .trn files from test TFRecords (the
port's own copy of ``srf_tpu/tools/make_ref.py``).

The reference recipes assume pre-existing ``test.ref`` files
(reference: egs/script/train_srf_timit.sh:76). This tool derives them from
the TFRecord target labels with the same token mapping log2utt applies to
hypotheses (TIMIT 61->39 phones, WSJ characters), so the full
train->decode->score loop is self-contained.

Usage:
    python -m srf_tpu_torch.tools.make_ref <tfrecord-pattern> <vocab> \
        [--corpus timit|wsj] > test.ref
"""

import argparse
import glob

from srf_tpu_torch.data.example_proto import decode_example
from srf_tpu_torch.data.tfrecord import read_records
from srf_tpu_torch.utils.log2utt import ids_to_utt


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("pattern")
    parser.add_argument("vocab")
    parser.add_argument("--corpus", default="timit", choices=["timit", "wsj"])
    args = parser.parse_args(argv)

    vocab = [line.strip() for line in open(args.vocab)]
    for path in sorted(glob.glob(args.pattern)):
        for record in read_records(path):
            ex = decode_example(record)
            ids = [int(i) for i in ex["target_label"]]
            utt_id = ex["utt_id"][0].decode("utf-8")
            print("%s (%s)" % (ids_to_utt(ids, vocab, args.corpus), utt_id))


if __name__ == "__main__":
    main()
