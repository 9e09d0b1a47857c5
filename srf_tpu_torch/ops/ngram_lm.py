"""Character/phone n-gram language model for shallow-fusion decoding (the
port's own copy of ``srf_tpu/ops/ngram_lm.py``, numpy only).

The reference decodes with a pure acoustic CTC beam
(``tf.nn.ctc_beam_search_decoder``, reference: tfsr/trainer_sr.py:110-112)
and has no language model anywhere. Shallow fusion is the standard ASR
upgrade: rank beam candidates by ``log P_ctc(y|x) + w * log P_lm(y) +
bonus * |y|`` so the search prefers linguistically plausible prefixes.

Design: the LM is a **dense conditional table**
``logp[context, symbol]`` with Witten-Bell interpolated backoff folded in
at training time, so decode-time scoring is ONE gather per beam per step —
no tries, no host callbacks, one indexing op inside the device beam
(ops/ctc_beam.py). Contexts are base-(V+1) encodings of the last
``order-1`` symbols (digit V = BOS), so carrying the LM state per beam is
a single uint32 that updates in closed form on every extend:

    ctx' = (ctx % B**(order-2)) * B + sym        (B = V + 1)

Dense tables are the right trade for speech output vocabularies (TIMIT 62
phones / WSJ 31 chars: a 4-gram table is 62 MB; BPE-scale vocabs want a
pruned/assoc representation and are out of scope — guarded at build time).
"""

import json

import numpy as np

_MAX_TABLE_BYTES = 512 * 1024 * 1024


def _n_contexts(vocab_size, order):
    return (vocab_size + 1) ** max(order - 1, 0)


class NGramLM:
    """Dense interpolated n-gram over token ids ``0..vocab_size-1``.

    ``table`` is ``[B**(order-1), vocab_size]`` float32 log-probabilities,
    each row a normalized conditional ``P(sym | ctx)`` with backoff already
    interpolated in. ``order == 1`` degenerates to a single unigram row.
    """

    def __init__(self, table, order, vocab_size):
        table = np.asarray(table, np.float32)
        expect = (_n_contexts(vocab_size, order), vocab_size)
        if table.shape != expect:
            raise ValueError(
                "LM table shape %s does not match order=%d vocab=%d "
                "(expected %s)" % (table.shape, order, vocab_size, expect)
            )
        self.table = table
        self.order = int(order)
        self.vocab_size = int(vocab_size)
        self.base = self.vocab_size + 1  # context digit alphabet incl. BOS

    # --- context arithmetic (mirrored on the device in ops/ctc_beam.py) ---

    @property
    def ctx0(self):
        """Start-of-sequence context: every digit is the BOS symbol V."""
        m = self.order - 1
        if m <= 0:
            return 0
        return sum(self.vocab_size * self.base**j for j in range(m))

    def next_ctx(self, ctx, sym):
        if self.order <= 1:
            return 0
        keep = self.base ** max(self.order - 2, 0)
        return (ctx % keep) * self.base + int(sym)

    def logp(self, ctx, sym):
        return float(self.table[int(ctx), int(sym)])

    # --- persistence ---

    def score_ids(self, ids):
        """Total log P of a complete id sequence (host-side)."""
        ctx, total = self.ctx0, 0.0
        for sym in ids:
            total += self.logp(ctx, sym)
            ctx = self.next_ctx(ctx, sym)
        return total

    def perplexity(self, seqs):
        """Per-token perplexity over an iterable of id sequences
        (``tools/train_ngram_lm.py`` logs it)."""
        total, n = 0.0, 0
        for ids in seqs:
            total += self.score_ids(ids)
            n += len(ids)
        if n == 0:
            return float("inf")
        return float(np.exp(-total / n))

    def save(self, path):
        np.savez_compressed(
            path,
            table=self.table,
            meta=json.dumps(
                {"order": self.order, "vocab_size": self.vocab_size}
            ),
        )

    @classmethod
    def load(cls, path):
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["meta"]))
            return cls(data["table"], meta["order"], meta["vocab_size"])


def train_ngram(seqs, vocab_size, order):
    """Witten-Bell interpolated n-gram from id sequences.

    Recursively ``P_m(s|ctx) = (c(ctx,s) + T(ctx) P_{m-1}(s|ctx'))
    / (c(ctx) + T(ctx))`` with ``T`` the distinct-continuation count, down
    to a unigram interpolated with the uniform distribution; unseen
    contexts fall back to the lower order exactly. Every order's context
    table is dense, so the whole estimation is vectorized numpy.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    if vocab_size < 1:
        raise ValueError("vocab_size must be >= 1")
    n_ctx = _n_contexts(vocab_size, order)
    if n_ctx * vocab_size * 4 > _MAX_TABLE_BYTES:
        raise ValueError(
            "dense %d-gram over %d symbols needs %.1f GB; dense tables "
            "target speech-sized vocabularies (reduce order or vocab)"
            % (order, vocab_size, n_ctx * vocab_size * 4 / 2**30)
        )
    base = vocab_size + 1
    lm = NGramLM(
        np.zeros((n_ctx, vocab_size), np.float32), order, vocab_size
    )

    # counts per order: counts[m] is [base**m, vocab_size] for context
    # length m (m = 0 .. order-1); vectorized per sequence — the context
    # id at position t is sum_j s[t-j] * base**(j-1) (BOS-padded), built
    # with ``order`` shifted adds, then one np.add.at scatter
    counts = [
        np.zeros((base**m, vocab_size), np.float64)
        for m in range(order)
    ]
    for ids in seqs:
        syms = np.asarray(ids, np.int64)
        if syms.size == 0:
            continue
        if syms.min() < 0 or syms.max() >= vocab_size:
            raise ValueError(
                "token id %d outside vocab %d"
                % (syms.min() if syms.min() < 0 else syms.max(), vocab_size)
            )
        # padded[t] = BOS for t < order-1, then the sequence
        padded = np.concatenate(
            [np.full((order - 1,), vocab_size, np.int64), syms]
        )
        t0 = order - 1  # index of syms[0] in padded
        for m in range(order):
            ctx = np.zeros((syms.size,), np.int64)
            for j in range(1, m + 1):
                ctx += padded[t0 - j: t0 - j + syms.size] * base ** (j - 1)
            np.add.at(counts[m], (ctx, syms), 1.0)

    # unigram, interpolated with uniform via Witten-Bell
    c1 = counts[0][0]
    n_tok, types = c1.sum(), float((c1 > 0).sum())
    if n_tok == 0:
        prob = np.full((vocab_size,), 1.0 / vocab_size)
    else:
        prob = (c1 + types / vocab_size) / (n_tok + types)
    prob = prob[None, :]  # [1, V]

    for m in range(1, order):
        cm = counts[m]  # [base**m, V]
        ctx_tot = cm.sum(axis=-1)  # [base**m]
        types = (cm > 0).sum(axis=-1).astype(np.float64)
        # context of length m backs off to its m-1 most recent symbols:
        # the low base**(m-1) digits of the encoding
        lower = (
            np.arange(base**m, dtype=np.int64) % base ** (m - 1)
        )
        p_lower = prob[lower]  # [base**m, V]
        seen = ctx_tot > 0
        denom = np.where(seen, ctx_tot + types, 1.0)[:, None]
        prob = np.where(
            seen[:, None],
            (cm + types[:, None] * p_lower) / denom,
            p_lower,
        )

    lm.table = np.log(np.maximum(prob, 1e-30)).astype(np.float32)
    return lm


def lm_ctx0(vocab_size, order):
    """Start context encoding for a given order (all digits BOS)."""
    m = order - 1
    base = vocab_size + 1
    return sum(vocab_size * base**j for j in range(m)) if m > 0 else 0


def load_lm_from_config(config, logger=None):
    """Resolve the --tpu-lm-* flags into (NGramLM, weight, bonus) or None.

    The path resolves against --path-base like every other path flag
    (reference semantics: misc_helper.py:62-75)."""
    path = getattr(config, "tpu_lm_path", None)
    if not path:
        return None
    base = getattr(config, "path_base", None)
    if base:
        from srf_tpu_torch.utils.vocab import get_file_path

        path = get_file_path(base, path)
    lm = NGramLM.load(path)
    weight = float(getattr(config, "tpu_lm_weight", 0.3))
    bonus = float(getattr(config, "tpu_lm_bonus", 0.0))
    if logger is not None:
        logger.info(
            "shallow fusion: %d-gram LM over %d symbols from %s "
            "(weight %.3f, bonus %.3f)",
            lm.order, lm.vocab_size, path, weight, bonus,
        )
    return lm, weight, bonus
