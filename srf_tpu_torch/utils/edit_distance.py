"""Minimum-edit token alignment for the in-framework scorer (the part of
``srf_tpu/utils/edit_distance.py`` that ``utils/score.py`` uses).

Port of the reference's in-graph ``compute_wer`` edit distance
(reference: tfsr/helper/train_helper.py:323-379), on the host.
"""


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
