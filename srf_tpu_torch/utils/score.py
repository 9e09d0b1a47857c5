"""In-framework scorer for trn-format hypothesis/reference files (the
port's own copy of ``srf_tpu/utils/score.py``).

Computes WER/PER over sclite "trn" files (``tokens ... (utt_id)`` lines,
the format log2utt emits and sclite consumes) so scoring works without the
external NIST binary. Word-level edit distance matches sclite's counts,
and the optional reports mirror what the reference's scoring step reads
off sclite (reference: egs/script/sclite.sh:2 runs ``-o pralign -o sum``):

- the summary always breaks errors into substitutions / deletions /
  insertions and correct-token percentage (the "-o sum" numbers);
- ``--pralign FILE`` writes a per-utterance alignment report: REF and HYP
  token rows padded to a common grid, an op row marking S/D/I columns,
  and per-utterance counts ("-o pralign" analog, original formatting);
- ``--confusions N`` appends the N most frequent substitution pairs plus
  top deletions/insertions — the error-analysis table PER debugging
  actually needs.

CLI:
    python -m srf_tpu_torch.utils.score <ref.trn> <hyp.trn> \
        [--pralign align.txt] [--confusions 10]
"""

import re
import sys
from collections import Counter

from srf_tpu_torch.utils.edit_distance import align_tokens

_TRN_RE = re.compile(r"^(.*)\(([^()]+)\)\s*$")


def load_trn(path):
    utts = {}
    with open(path) as f:
        for line in f:
            match = _TRN_RE.match(line.strip())
            if match:
                text, utt_id = match.group(1).strip(), match.group(2).strip()
                utts[utt_id] = text.split() if text else []
    return utts


def _format_alignment(utt_id, ops):
    """One utterance's pralign-style block: gridded REF/HYP/op rows."""
    ref_row, hyp_row, op_row = [], [], []
    for op, ref_tok, hyp_tok in ops:
        ref_cell = ref_tok if ref_tok is not None else "***"
        hyp_cell = hyp_tok if hyp_tok is not None else "***"
        if op != "C":
            # errors stand out in caps, as in sclite pralign output
            ref_cell, hyp_cell = ref_cell.upper(), hyp_cell.upper()
        width = max(len(ref_cell), len(hyp_cell), 1)
        ref_row.append(ref_cell.ljust(width))
        hyp_row.append(hyp_cell.ljust(width))
        op_row.append((op if op != "C" else " ").ljust(width))
    counts = Counter(op for op, _, _ in ops)
    lines = [
        "id: (%s)" % utt_id,
        "REF: %s" % " ".join(ref_row).rstrip(),
        "HYP: %s" % " ".join(hyp_row).rstrip(),
        "OP : %s" % " ".join(op_row).rstrip(),
        "C=%d S=%d D=%d I=%d"
        % (counts["C"], counts["S"], counts["D"], counts["I"]),
        "",
    ]
    return "\n".join(lines)


def score(ref_path, hyp_path, out=sys.stdout, pralign_path=None,
          confusions=0):
    refs = load_trn(ref_path)
    hyps = load_trn(hyp_path)
    totals = Counter()
    total_words = 0
    missing = 0
    subs, dels, ins = Counter(), Counter(), Counter()
    pralign_out = open(pralign_path, "w") if pralign_path else None
    try:
        for utt_id, ref_tokens in refs.items():
            hyp_tokens = hyps.get(utt_id)
            if hyp_tokens is None:
                # sclite scores every reference utterance: a missing
                # hypothesis is all deletions, not an exclusion (excluding
                # it would let a half-crashed decode report a BETTER rate
                # than a complete one)
                missing += 1
                hyp_tokens = []
            ops = align_tokens(ref_tokens, hyp_tokens)
            for op, ref_tok, hyp_tok in ops:
                totals[op] += 1
                if op == "S":
                    subs[(ref_tok, hyp_tok)] += 1
                elif op == "D":
                    dels[ref_tok] += 1
                elif op == "I":
                    ins[hyp_tok] += 1
            total_words += len(ref_tokens)
            if pralign_out is not None:
                pralign_out.write(_format_alignment(utt_id, ops) + "\n")
    finally:
        if pralign_out is not None:
            pralign_out.close()
    total_err = totals["S"] + totals["D"] + totals["I"]
    denom = max(total_words, 1)
    wer = 100.0 * total_err / denom
    out.write(
        "Utterances scored: %d (missing hyp: %d)\n"
        % (len(refs) - missing, missing)
    )
    out.write(
        "Word/Token Error Rate: %.2f%% (%d errors / %d tokens)\n"
        % (wer, total_err, total_words)
    )
    out.write(
        "Corr=%.1f%% Sub=%.1f%% Del=%.1f%% Ins=%.1f%% "
        "(C=%d S=%d D=%d I=%d)\n"
        % (
            100.0 * totals["C"] / denom, 100.0 * totals["S"] / denom,
            100.0 * totals["D"] / denom, 100.0 * totals["I"] / denom,
            totals["C"], totals["S"], totals["D"], totals["I"],
        )
    )
    if confusions > 0:
        out.write("Top confusion pairs (ref -> hyp x count):\n")
        for (ref_tok, hyp_tok), n in subs.most_common(confusions):
            out.write("  %s -> %s x %d\n" % (ref_tok, hyp_tok, n))
        if dels:
            top_d = ", ".join(
                "%s x %d" % kv for kv in dels.most_common(confusions)
            )
            out.write("Top deletions: %s\n" % top_d)
        if ins:
            top_i = ", ".join(
                "%s x %d" % kv for kv in ins.most_common(confusions)
            )
            out.write("Top insertions: %s\n" % top_i)
    return wer


def main(argv=None):
    argv = list(argv or sys.argv[1:])
    pralign_path, confusions = None, 0
    pos = []
    it = iter(argv)
    for arg in it:
        if arg == "--pralign" or arg.startswith("--pralign="):
            pralign_path = (arg.split("=", 1)[1] if "=" in arg
                            else next(it, None))
            if not pralign_path:
                print("--pralign requires a file path")
                return 1
        elif arg == "--confusions" or arg.startswith("--confusions="):
            val = arg.split("=", 1)[1] if "=" in arg else next(it, None)
            if not val:
                print("--confusions requires a count")
                return 1
            confusions = int(val)
        else:
            pos.append(arg)
    if len(pos) != 2:
        print(
            "usage: python -m srf_tpu_torch.utils.score <ref.trn> <hyp.trn> "
            "[--pralign align.txt] [--confusions N]"
        )
        return 1
    score(pos[0], pos[1], pralign_path=pralign_path, confusions=confusions)
    return 0


if __name__ == "__main__":
    sys.exit(main())
