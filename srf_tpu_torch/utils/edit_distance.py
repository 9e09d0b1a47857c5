"""In-framework WER and edit distance, on the host (port of
``srf_tpu/utils/edit_distance.py``).

Port of the reference's in-graph ``compute_wer``
(reference: tfsr/helper/train_helper.py:323-379): ids -> tokens through
the vocab, joined, the same regex clean-up chain (EOS tail, noise 'n', BPE
markers, BOS '@', EOS '$', pad 'p', whitespace), split into words, and the
word-level Levenshtein distance (not normalised) with the reference word
counts. :func:`levenshtein` also scores MWER's hypotheses
(``train/mwer.py``); :func:`align_tokens` backs ``utils/score.py``.
"""

import re

import numpy as np

_CLEANUPS = [
    (re.compile(r"<EOS>.*"), ""),
    (re.compile(r"n"), ""),      # non-lang syms
    (re.compile(r"@@ "), ""),    # bpe join: before the '@' removals below
    (re.compile(r"@ "), ""),     # bos <space>
    (re.compile(r" \$"), ""),    # <space> eos
    (re.compile(r"\$"), ""),     # eos
    (re.compile(r"@"), ""),      # bos
    (re.compile(r"p"), ""),      # padding syms
    (re.compile(r" +"), " "),    # double blanks
    (re.compile(r"^ "), ""),     # strip
    (re.compile(r" $"), ""),     # strip
]


def assemble_to_words(ids, vocab):
    """ids -> the words the reference's clean-up chain leaves."""
    joined = "".join(vocab[int(i)] for i in ids)
    for pattern, repl in _CLEANUPS:
        joined = pattern.sub(repl, joined)
    return joined.split(" ") if joined else []


def levenshtein(a, b):
    """Edit distance between two sequences (insertions, deletions and
    substitutions cost 1)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ai in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, bj in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ai != bj))
        prev = cur
    return prev[-1]


def compute_wer(hyp, ref, vocab):
    """Batched: (errors [B], ref_word_counts [B]) as the reference's
    (distances, ref_lens)."""
    hyp = np.atleast_2d(np.asarray(hyp))
    ref = np.atleast_2d(np.asarray(ref))
    errors = np.zeros((hyp.shape[0],), np.float32)
    ref_lens = np.zeros((hyp.shape[0],), np.float32)
    for i in range(hyp.shape[0]):
        hyp_words = assemble_to_words(hyp[i], vocab)
        ref_words = assemble_to_words(ref[i], vocab)
        errors[i] = levenshtein(hyp_words, ref_words)
        ref_lens[i] = len(ref_words)
    return errors, ref_lens


def wer_tokens(hyp_tokens, ref_tokens):
    """Plain token-level (errors, ref_len) for lists of strings."""
    return levenshtein(hyp_tokens, ref_tokens), len(ref_tokens)


def align_tokens(ref_tokens, hyp_tokens):
    """Minimum-edit alignment between token lists.

    Returns a list of (op, ref_tok, hyp_tok) with op in {"C", "S", "D",
    "I"} (correct / substitution / deletion / insertion; the missing side
    is None). Ties prefer substitution over insert+delete pairs, matching
    how sclite reports alignments. Backs the scorer's counts and its
    pralign-style report (utils/score.py).
    """
    n, m = len(ref_tokens), len(hyp_tokens)
    # dist[i][j]: edit distance between ref[:i] and hyp[:j]
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dist[i][0] = i
    for j in range(1, m + 1):
        dist[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1][j - 1] + (ref_tokens[i - 1] != hyp_tokens[j - 1])
            dist[i][j] = min(sub, dist[i - 1][j] + 1, dist[i][j - 1] + 1)
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i][j] == dist[i - 1][j - 1] + (
            ref_tokens[i - 1] != hyp_tokens[j - 1]
        ):
            op = "C" if ref_tokens[i - 1] == hyp_tokens[j - 1] else "S"
            ops.append((op, ref_tokens[i - 1], hyp_tokens[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            ops.append(("D", ref_tokens[i - 1], None))
            i -= 1
        else:
            ops.append(("I", None, hyp_tokens[j - 1]))
            j -= 1
    ops.reverse()
    return ops
