"""The port's streaming (srf_tpu_torch.streaming, the model's route_block /
stream_step, routing_cuda.sequential_routing_stream's plain route) against
srf_tpu's on the same numpy weights, on the CPU.

Streamed logits must equal JAX's streamed logits and the port's own batch
forward on every valid frame within atol 3e-5 (float32 sums in another
order through 3 routing layers and 4 LayerNorms; JAX's own streaming test
holds its streaming to its batch forward at the same limit), at chunks 3,
8 and 13, for the naive, lowmemory and einsum flavors, DR and two other
front-end geometries. Greedy ids, the streamed beam (with a fused 3-gram
LM) and long-form segments must be equal; beam scores within rtol 1e-5.
"""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops.ngram_lm import NGramLM as JaxNGramLM
from srf_tpu.ops.routing import sequential_routing as jax_sequential_routing
from srf_tpu.serve import Recognizer as JaxRecognizer
from srf_tpu.streaming import StreamingTranscriber as JaxStreamingTranscriber
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.ops import routing, routing_cuda
from srf_tpu_torch.ops.ctc_beam import ctc_beam_search_batch
from srf_tpu_torch.ops.ngram_lm import train_ngram
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.streaming import StreamingPool, StreamingTranscriber

from _torch_parity import random_flax_variables

torch.set_num_threads(1)

FEAT = 10
VOCAB = 6  # class_n = VOCAB + 1, the blank last
ATOL = 3e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kwargs(caps_type="naive", is_context=True, caps_iter=1, lpad=1, rpad=1,
            conv_layer_num=2, stride=2, feat_dim=FEAT, class_n=VOCAB + 1):
    return dict(
        feat_dim=feat_dim, class_n=class_n, enc_num=3, caps_primary_num=6,
        caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
        caps_class_dim=4, caps_iter=caps_iter, lpad=lpad, rpad=rpad,
        is_context=is_context, conv_layer_num=conv_layer_num,
        conv_filter_num=8, caps_type=caps_type, stride=stride)


def _pair(seed=3, **kw):
    """(flax model, its variables, the port model with the same weights,
    in eval mode)."""
    kwargs = _kwargs(**kw)
    flax_model = FlaxSequenceRouter(**kwargs)
    variables = random_flax_variables(flax_model, kwargs["feat_dim"],
                                      seed=seed)
    model = SequenceRouter(**kwargs)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return flax_model, variables, model.eval()


def _batch_logits(model, raw):
    """The port's batch forward of one utterance, zero-padded generously
    (+64 frames, a multiple of the subsampling) so that its valid frames do
    not depend on where the array ends, as JAX's streaming test pads."""
    div = model.stride ** model.conv_layer_num
    t_true = raw.shape[0]
    pad = np.zeros((1, -(-(t_true + 64) // div) * div, raw.shape[1]),
                   np.float32)
    pad[0, :t_true] = raw
    with torch.no_grad():
        return model(torch.from_numpy(pad), torch.tensor([t_true]))[0].numpy()


def _stream(session, raw, step=7):
    tokens = []
    for start in range(0, raw.shape[0], step):
        tokens += session.push(raw[start : start + step])
    tail = session.flush()
    return tokens, tail


CASES = {
    "naive": dict(),
    "lowmemory": dict(caps_type="lowmemory"),
    "einsum": dict(caps_type="einsum"),
    "dr": dict(is_context=False),
    "iter2_window2+1": dict(caps_iter=2, lpad=2, rpad=1),
    "conv1_stride2": dict(conv_layer_num=1),
    "conv2_stride3": dict(stride=3),
}


@pytest.mark.parametrize("chunk", [3, 8, 13])
@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_logits_match_the_batch_forward(case, chunk):
    _, _, model = _pair(**CASES[case])
    div = model.stride ** model.conv_layer_num
    t_true = 8 * div + 21
    raw = np.random.RandomState(3).randn(t_true, FEAT).astype(np.float32)
    session = StreamingTranscriber(model, blank_id=VOCAB, chunk=chunk)
    tokens, tail = _stream(session, raw)
    t_ceil = -(-t_true // div)
    full = _batch_logits(model, raw)
    got = session.logits
    assert got.shape[0] >= t_ceil
    np.testing.assert_allclose(got[:t_ceil], full[:t_ceil], atol=ATOL)
    # greedy tokens: the offline greedy decode of the batch logits
    ids = np.argmax(full[: t_true // div], axis=-1)
    want = [int(x) for i, x in enumerate(ids)
            if x != VOCAB and (i == 0 or x != ids[i - 1])]
    assert tokens + tail == want


@pytest.mark.parametrize("case,chunk", [
    ("naive", 8), ("lowmemory", 3), ("einsum", 13), ("dr", 8),
    ("conv2_stride3", 3),
])
def test_streamed_logits_match_jax_streaming(case, chunk):
    flax_model, variables, model = _pair(**CASES[case])
    div = model.stride ** model.conv_layer_num
    t_true = 53
    raw = np.random.RandomState(5).randn(t_true, FEAT).astype(np.float32)
    jax_session = JaxStreamingTranscriber(flax_model, variables,
                                          blank_id=VOCAB, chunk=chunk)
    want_tokens, want_tail = _stream(jax_session, raw)
    session = StreamingTranscriber(model, blank_id=VOCAB, chunk=chunk)
    tokens, tail = _stream(session, raw)
    assert session.logits.shape == jax_session.logits.shape
    np.testing.assert_allclose(session.logits, jax_session.logits, atol=ATOL)
    assert (tokens, tail) == (want_tokens, list(want_tail))
    assert session.token_frames == jax_session.token_frames
    assert session._raw_base == jax_session._raw_base
    assert -(-t_true // div) <= session.logits.shape[0]


def test_route_block_and_stream_step_match_jax():
    flax_model, variables, model = _pair(caps_iter=2, lpad=2, rpad=1)
    rng = np.random.RandomState(7)
    for layer, (in_n, out_n, out_d, in_d) in enumerate(model.layer_shapes()):
        n = in_n // 4  # window 2+1+1
        u_ctx = rng.randn(2, 3 + 8, n, in_d).astype(np.float32)
        v_init = rng.randn(2, out_n, out_d).astype(np.float32) * 0.3
        valid = np.arange(8) >= 3
        want = flax_model.apply(variables, jnp.asarray(u_ctx), layer,
                                jnp.asarray(v_init), jnp.asarray(valid),
                                method="route_block")
        with torch.no_grad():
            got = model.route_block(torch.from_numpy(u_ctx), layer,
                                    torch.from_numpy(v_init),
                                    torch.from_numpy(valid))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        assert not got[0][:, :3].any()

    # one whole step: window, per-layer buffers and carries, warm-up
    lm, rm = model.stream_margin_posts()
    k = 8
    win = 4 * (k + lm + rm)
    window = rng.randn(1, win, FEAT).astype(np.float32)
    bufs, vprevs = [], []
    prev_n, prev_d = model.caps_primary_num, model.caps_primary_dim
    for _, out_n, out_d, _ in model.layer_shapes():
        bufs.append(rng.randn(1, 3, prev_n, prev_d).astype(np.float32))
        vprevs.append(rng.randn(1, out_n, out_d).astype(np.float32) * 0.3)
        prev_n, prev_d = out_n, out_d
    offsets = np.asarray([2, 1, -1])
    want = flax_model.apply(
        variables, jnp.asarray(window), jnp.asarray(win - 5), jnp.asarray(2),
        [jnp.asarray(b) for b in bufs], [jnp.asarray(v) for v in vprevs],
        jnp.asarray(offsets), method="stream_step")
    with torch.no_grad():
        got = model.stream_step(
            torch.from_numpy(window), torch.tensor([win - 5]), [2],
            [torch.from_numpy(b) for b in bufs],
            [torch.from_numpy(v) for v in vprevs], offsets[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)
    for g_list, w_list in zip(got[1:], want[1:]):
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_plain_step_valid_rows_match_a_jax_vmap():
    """The plain SDR with a [B, T] step mask and a carry per row, against
    JAX's scan vmapped over rows (a pool's slots warm up apart)."""
    rng = np.random.RandomState(11)
    u = rng.randn(3, 9, 12, 4).astype(np.float32)
    w = (rng.randn(12, 5, 4, 4) * 0.3).astype(np.float32)
    b = (rng.randn(12, 5, 4) * 0.1).astype(np.float32)
    v0 = (rng.randn(3, 5, 4) * 0.3).astype(np.float32)
    valid = np.arange(9)[None] >= np.asarray([[0], [4], [9]])
    for num_iter, mask in ((1, False), (2, True)):
        want = jax.vmap(
            lambda uu, vv, sv: jax_sequential_routing(
                uu[None], w, b, num_iter, mask, v_init=vv[None],
                step_valid=sv)[0])(u, v0, valid)
        got = routing.sequential_routing(
            torch.from_numpy(u), torch.from_numpy(w), torch.from_numpy(b),
            num_iter, mask, torch.from_numpy(v0), torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        # the stream entry point takes the plain route on the CPU
        routing.sequential_routing_from_uhat.cuda_calls = 0
        stream = routing_cuda.sequential_routing_stream(
            torch.from_numpy(u), torch.from_numpy(w), torch.from_numpy(b),
            num_iter, mask, torch.from_numpy(v0), torch.from_numpy(valid))
        assert torch.equal(stream, got)
        assert routing.sequential_routing_from_uhat.cuda_calls == 0
        assert not stream[2].any() and not stream[1, :4].any()


def test_stream_routing_is_forward_only_and_k1_takes_cuda_only():
    u = torch.randn(1, 4, 6, 4)
    w = torch.randn(6, 5, 4, 4, requires_grad=True)
    b = torch.randn(6, 5, 4)
    with pytest.raises(RuntimeError, match="forward-only"):
        routing_cuda.sequential_routing_stream(u, w, b, 1, False,
                                               torch.zeros(1, 5, 4))
    with torch.no_grad():
        assert routing_cuda.sequential_routing_stream(
            u, w, b, 1, False).shape == (1, 4, 5, 4)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        routing_cuda.sequential_routing_cuda(u, w.detach(), b, 1, False,
                                             torch.zeros(1, 5, 4))


def _lm():
    rng = np.random.RandomState(9)
    port = train_ngram([list(rng.randint(0, VOCAB, size=12))
                        for _ in range(30)], VOCAB, 3)
    return port, JaxNGramLM(port.table, port.order, port.vocab_size)


@pytest.mark.parametrize("with_lm", [False, True])
def test_streamed_beam_matches_jax_and_the_offline_beam(with_lm):
    flax_model, variables, model = _pair()
    raw = np.random.RandomState(23).randn(77, FEAT).astype(np.float32)
    port_lm, jax_lm = _lm()
    lm = (port_lm, 0.5, 0.5) if with_lm else None
    jax_session = JaxStreamingTranscriber(
        flax_model, variables, blank_id=VOCAB, chunk=8, beam_width=8,
        lm=(jax_lm, 0.5, 0.5) if with_lm else None)
    session = StreamingTranscriber(model, blank_id=VOCAB, chunk=8,
                                   beam_width=8, lm=lm)
    want_tokens, (want_ids, want_score) = _stream(jax_session, raw, 13)
    tokens, (ids, score) = _stream(session, raw, 13)
    assert tokens == want_tokens
    assert ids == want_ids and len(ids) > 0
    np.testing.assert_allclose(score, want_score, rtol=1e-5)
    # the streamed beam is the offline beam on the same logits
    t_dec = 77 // 4
    (off_ids, off_score), = ctc_beam_search_batch(
        session.logits[None, :t_dec], [t_dec], 8, VOCAB, lm=lm)
    assert ids == off_ids
    np.testing.assert_allclose(score, off_score, rtol=1e-5)
    got = session.hypothesis(with_frames=True)
    want = jax_session.hypothesis(with_frames=True)
    assert got[0] == want[0] and got[2] == want[2]


def test_flush_with_a_beam_rescores_offline_as_jax():
    flax_model, variables, model = _pair()
    raw = np.random.RandomState(13).randn(61, FEAT).astype(np.float32)
    jax_session = JaxStreamingTranscriber(flax_model, variables,
                                          blank_id=VOCAB, chunk=8)
    jax_session.push(raw)
    session = StreamingTranscriber(model, blank_id=VOCAB, chunk=8)
    session.push(raw)
    assert list(session.flush(beam_width=8)) == list(
        jax_session.flush(beam_width=8))


@pytest.mark.parametrize("beam", [None, 8])
@pytest.mark.parametrize("caps_type", ["naive", "einsum"])
def test_pool_matches_single_sessions(caps_type, beam):
    """Three staggered streams through one batched step per tick decode
    as three standalone sessions (greedy ids, or the final beam)."""
    _, _, model = _pair(caps_type=caps_type)
    rng = np.random.RandomState(3)
    utts = [rng.randn(t, FEAT).astype(np.float32) for t in (57, 33, 70)]
    singles = []
    for raw in utts:
        s = StreamingTranscriber(model, blank_id=VOCAB, chunk=4,
                                 beam_width=beam)
        tokens, tail = _stream(s, raw, len(raw))
        singles.append((tokens, tail))
    pool = StreamingPool(model, blank_id=VOCAB, slots=3, chunk=4,
                         beam_width=beam)
    toks = [[], [], []]
    offs, sizes = [0, 0, 0], [13, 7, 19]
    while any(offs[i] < len(utts[i]) for i in range(3)):
        for i in range(3):
            if offs[i] < len(utts[i]):
                pool.push(i, utts[i][offs[i] : offs[i] + sizes[i]])
                offs[i] += sizes[i]
        for slot, new in pool.step().items():
            toks[slot].extend(new)
    for i in range(3):
        tail = pool.flush(i)
        if beam:
            assert toks[i] == singles[i][0]
            assert tail[0] == singles[i][1][0]
            np.testing.assert_allclose(tail[1], singles[i][1][1], rtol=1e-5)
        else:
            assert toks[i] + tail == singles[i][0] + singles[i][1]


def test_pool_slot_flush_is_independent():
    _, _, model = _pair()
    rng = np.random.RandomState(5)
    a, b, c = (rng.randn(n, FEAT).astype(np.float32) for n in (48, 64, 36))

    def single(raw):
        s = StreamingTranscriber(model, blank_id=VOCAB, chunk=4)
        s.push(raw)
        s.flush()
        return list(s._tokens)

    pool = StreamingPool(model, blank_id=VOCAB, slots=2, chunk=4)
    toks = {0: [], 1: []}
    pool.push(0, a)
    pool.push(1, b[:30])
    for slot, new in pool.step().items():
        toks[slot].extend(new)
    toks[0].extend(pool.flush(0))     # slot 0 done; slot 1 mid-stream
    pool.push(1, b[30:])
    pool.push(0, c)                   # reuse the flushed slot
    while True:
        got = pool.step()
        if not got:
            break
        for slot, new in got.items():
            toks[slot].extend(new)
    c_toks = list(pool.flush(0))
    toks[1].extend(pool.flush(1))
    assert toks[1] == single(b)
    assert toks[0] + c_toks == single(a) + single(c)


def test_long_stream_buffers_stay_bounded():
    _, _, model = _pair()
    rng = np.random.RandomState(9)
    s = StreamingTranscriber(model, blank_id=VOCAB, chunk=4)
    bound = s.win + s.K * s.div + s.lmargin
    for _ in range(100):
        s.push(rng.randn(40, FEAT).astype(np.float32))
        assert s._raw.shape[0] <= bound + 40, s._raw.shape
    assert s._raw_base + s._raw.shape[0] == s._pushed
    total = s._logit_frames
    np.testing.assert_array_equal(s.logits_slice(total - 7, total),
                                  s.logits[total - 7 : total])


def _inject(session, path):
    """Sharp logits straight into the decode state (the endpointing
    bookkeeping, apart from the acoustic cascade)."""
    logits = np.full((len(path), VOCAB + 1), -10.0, np.float32)
    logits[np.arange(len(path)), path] = 10.0
    session._logits.append(logits)
    session._logit_frames += len(path)
    session._logit_ends.append(session._logit_frames)
    session._decode_available(limit=None)
    if session.beam_width:
        session._beam_advance(limit=None)


@pytest.mark.parametrize("beam", [None, 4])
def test_endpoint_and_segments(beam):
    _, _, model = _pair()
    session = StreamingTranscriber(model, blank_id=VOCAB, chunk=4,
                                   beam_width=beam)
    blank = VOCAB
    _inject(session, [blank] * 20)
    assert not session.endpoint_detected(5)  # silence alone never ends
    seg0 = session.finalize_segment()
    assert seg0["ids"] == []
    _inject(session, [blank, blank, 1, blank, blank, blank, blank, blank])
    assert session.trailing_blank_frames == 5
    assert session.endpoint_detected(5) and not session.endpoint_detected(6)
    seg1 = session.finalize_segment()
    assert (seg1["ids"], seg1["frames"]) == ([1], [22])
    assert (seg1["start_frame"], seg1["end_frame"]) == (20, 28)
    _inject(session, [blank, 3, 3, blank])
    seg2 = session.finalize_segment()
    assert (seg2["ids"], seg2["frames"]) == ([3], [29])
    if beam:
        assert seg1["score"] < 1e-6 and seg2["score"] < 1e-6


def test_transcribe_long_segments_match_jax(tmp_path):
    """Recognizer.transcribe_long on both packages, same weights: the same
    segments (ids, frames, times, bounds, text), greedy and with a beam."""
    vocab = os.path.join(REPO, "egs", "data", "timit_62.vocab")
    kwargs = _kwargs(feat_dim=123, class_n=63)
    flax_model = FlaxSequenceRouter(**kwargs)
    variables = random_flax_variables(flax_model, 123, seed=4)
    logger = Logger(name="test_torch_streaming", level=Logger.WARN).logger
    config = ParseOption(
        ["serve", "--path-base=%s" % tmp_path, "--path-vocab=%s" % vocab,
         "--path-ckpt=%s" % tmp_path, "--feat-dim=123",
         "--model-encoder-num=3", "--model-caps-primary-num=6",
         "--model-caps-primary-dim=4", "--model-caps-convolution-num=5",
         "--model-caps-convolution-dim=4", "--model-caps-class-dim=4",
         "--model-caps-type=naive", "--model-caps-context=True",
         "--model-caps-iter=1", "--model-caps-window-lpad=1",
         "--model-caps-window-rpad=1", "--model-conv-filter-num=8"],
        logger, is_print_opts=False).args
    recognizer = Recognizer(config, device="cpu", logger=logger,
                            state_dict=convert.flax_to_state_dict(variables))
    # JAX's transcribe_long reads only these attributes of its Recognizer
    jax_recognizer = JaxRecognizer.__new__(JaxRecognizer)
    jax_recognizer.model = flax_model
    jax_recognizer.state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    jax_recognizer.quantized = False
    jax_recognizer.lm = None
    jax_recognizer.blank_id = 62
    jax_recognizer.in_len_div = 4
    jax_recognizer.vocab = recognizer.vocab
    rng = np.random.RandomState(17)
    feats = rng.randn(900, 123).astype(np.float32)
    feats[300:420] = 0.0  # silent gaps
    feats[650:760] = 0.0
    for beam in (None, 4):
        want = jax_recognizer.transcribe_long(
            feats, beam_width=beam, endpoint_blanks=3, max_segment_s=2.0)
        got = recognizer.transcribe_long(
            feats, beam_width=beam, endpoint_blanks=3, max_segment_s=2.0)
        assert len(got) == len(want) and len(got) > 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in ("ids", "text", "frames", "times", "start_s",
                        "end_s"):
                assert g[key] == w[key], key
            if beam:
                np.testing.assert_allclose(g["score"], w["score"],
                                           rtol=1e-5)


def test_streaming_takes_the_srf_only():
    with pytest.raises(TypeError, match="SequenceRouter"):
        StreamingTranscriber(torch.nn.Linear(2, 2), blank_id=4)
