"""The port's decode stage against the JAX package and its own serving path.

- ``train/loop.run_decoding`` prints byte-identical stdout to JAX's for a
  stub ``logits_fn`` returning fixed numpy logits (device and host beams,
  with and without a toy LM, and greedy; a ``pad_last`` batch's dummy rows
  print nothing);
- ``trainer_sr`` decode mode on the CPU, at a small SRF, from the port's
  averaged checkpoint of synthetic TFRecords written by the port's writer,
  gives the hypotheses of ``Recognizer.transcribe_batch(beam_width=...)``
  on the same features; ``utils/log2utt`` scrapes its stdout and
  ``utils/score`` scores the result;
- what decode mode does not port yet is refused.
"""

import io
import logging
import os

import numpy as np
import pytest
import torch

from srf_tpu.config import ParseOption as JaxParseOption
from srf_tpu.ops import ngram_lm as jax_lm
from srf_tpu.train import loop as jax_loop
from srf_tpu_torch import convert, trainer_sr
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.data.example_proto import encode_example
from srf_tpu_torch.data.tfrecord import TFRecordWriter
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops import ngram_lm
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.tools import average_ckpt
from srf_tpu_torch.train import loop
from srf_tpu_torch.utils import checkpoint, log2utt, score

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "egs", "data", "timit_62.vocab")
# the verify skill's small SRF
FLAGS = [
    "--feat-dim=8", "--feat-type=None", "--model-encoder-num=3",
    "--model-caps-primary-num=8", "--model-caps-primary-dim=4",
    "--model-caps-convolution-num=6", "--model-caps-convolution-dim=4",
    "--model-caps-class-dim=4", "--model-caps-type=naive",
    "--model-caps-context=True", "--model-caps-iter=1",
    "--model-caps-window-lpad=1", "--model-caps-window-rpad=1",
    "--model-conv-filter-num=8",
    "--path-test-ptrn=tfrecord/synth-test-None-8-*-of-*",
    "--prep-data-num-train=0", "--prep-data-num-valid=0",
]
LENGTHS = (150, 97, 233, 61, 128, 300, 45)
LOGGER = Logger(name="test_torch_decode", level=Logger.WARN).logger


class _Stub:
    """Fixed numpy logits per batch, as a logits_fn."""

    def __init__(self, logits):
        self.logits = logits
        self.calls = 0

    def __call__(self, state, batch):
        out = self.logits[self.calls]
        self.calls += 1
        return out


def _stub_batches():
    rng = np.random.RandomState(0)
    batches, logits = [], []
    for lens, n_real, V in (((200, 140, 33), 3, 63), ((90, 1), 1, 63)):
        width = 256 if max(lens) > 128 else 128
        batch = {"feats": np.zeros((len(lens), width, 8), np.float32),
                 "labels": np.ones((len(lens), 2), np.int32),
                 "inp_len": np.asarray(lens, np.int32),
                 "tar_len": np.full((len(lens),), 2, np.int32),
                 "valid": n_real,
                 "utt_ids": ["u%d_%d" % (len(batches), i)
                             for i in range(n_real)]}
        batches.append(batch)
        logits.append((3 * rng.randn(len(lens), width // 4, V)).astype(
            np.float32))
    return batches, logits


@pytest.mark.parametrize("impl,with_lm", [
    ("device", False), ("device", True), ("host", False), ("host", True),
    ("greedy", False)])
def test_run_decoding_prints_what_jax_prints(tmp_path, capsys, impl, with_lm):
    batches, logits = _stub_batches()
    argv = ["decode", "--path-base=%s" % tmp_path,
            "--decoding-beam-width=16", "--tpu-decode-impl=%s" % impl]
    if with_lm:
        rng = np.random.RandomState(4)
        seqs = [list(rng.randint(0, 62, size=9)) for _ in range(20)]
        ngram_lm.train_ngram(seqs, 62, 2).save(str(tmp_path / "lm.npz"))
        argv += ["--tpu-lm-path=lm.npz", "--tpu-lm-weight=0.4",
                 "--tpu-lm-bonus=0.5"]
    quiet = logging.getLogger("quiet")
    quiet.setLevel(logging.ERROR)
    outs = []
    for run, parse in ((jax_loop.run_decoding, JaxParseOption),
                       (loop.run_decoding, ParseOption)):
        config = parse(argv, quiet, is_print_opts=False).args
        capsys.readouterr()
        run(config, quiet, None, _Stub(logits), batches, 4)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    hyps = list(log2utt.parse_decode_log(io.StringIO(outs[1])))
    assert [u for u, _ in hyps] == ["u0_0", "u0_1", "u0_2", "u1_0"]
    assert all(len(ids) > 0 for _, ids in hyps)
    assert jax_lm.NGramLM  # the LM file is the JAX package's format too


def _write_split(base, seed=0, shards=2):
    """The test split as the JAX writer lays it out (data/writer.py), by
    the port's writer: utt ids, 8-dim features, labels 1..61."""
    rng = np.random.RandomState(seed)
    os.makedirs(base / "tfrecord", exist_ok=True)
    writers = [TFRecordWriter(str(
        base / "tfrecord" / ("synth-test-None-8-%d-of-%d" % (s, shards))))
        for s in range(shards)]
    feats = {}
    refs = []
    for i, n in enumerate(LENGTHS):
        utt = "utt%02d" % i
        x = rng.randn(n, 8).astype(np.float32)
        labels = rng.randint(1, 62, size=max(2, n // 20)).astype(np.int64)
        writers[i % shards].write(encode_example({
            "target_label": labels,
            "input_speech": x.flatten(),
            "input_length": np.asarray([n], np.int64),
            "target_length": np.asarray([labels.size], np.int64),
            "utt_id": [utt.encode()],
        }))
        feats[utt] = x
        refs.append((utt, [int(v) for v in labels]))
    for writer in writers:
        writer.close()
    return feats, refs


def _argv(base, *extra):
    return ["trainer_sr", "--path-base=%s" % base, "--path-vocab=%s" % VOCAB,
            "--path-ckpt=%s" % (base / "ckpt" / "avg"), "--device=cpu",
            "--train-max-epoch=0", "--decoding-beam-width=20", *FLAGS, *extra]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Synthetic TFRecords and an averaged checkpoint of three perturbed
    copies of one random model, as the recipe's stage 2 leaves them."""
    base = tmp_path_factory.mktemp("decode")
    feats, refs = _write_split(base)
    config = ParseOption(_argv(base), LOGGER, is_print_opts=False).args
    model, _ = build_model(config, 63)
    rng = np.random.RandomState(2)
    manager = checkpoint.CheckpointManager(str(base / "ckpt"))
    state = model.state_dict()
    for step in (1, 2, 3):
        perturbed = {k: (v + torch.from_numpy(
            0.3 * rng.randn(*v.shape).astype(np.float32))
            if v.is_floating_point() else v) for k, v in state.items()}
        manager.save(step, {"step": step, "model": perturbed,
                            "optimizer": None, "scheduler": None})
    average_ckpt.main(_argv(base, "--path-ckpt=%s" % (base / "ckpt"),
                            "--model-average-num=3"))
    return base, feats, refs


def _decode(base, capsys, *extra):
    capsys.readouterr()
    trainer_sr.main(_argv(base, *extra))
    return capsys.readouterr().out


def test_trainer_decode_equals_recognizer(corpus, capsys, tmp_path):
    base, feats, refs = corpus
    out = _decode(base, capsys)
    hyps = dict(log2utt.parse_decode_log(io.StringIO(out)))
    assert sorted(hyps) == sorted(feats)
    config = ParseOption(_argv(base), LOGGER, is_print_opts=False).args
    recognizer = Recognizer(config, logger=LOGGER)  # loads avg/1
    avg = checkpoint.CheckpointManager(str(base / "ckpt" / "avg")).restore(1)
    assert all(torch.equal(recognizer.model.state_dict()[k], v)
               for k, v in avg["model"].items())
    for utt, x in feats.items():
        (ids, _), = recognizer.transcribe_batch([x], beam_width=20)
        assert hyps[utt] == ids, utt
    # batch 3 with pad_last: the dummy row prints nothing, and each batch's
    # hypotheses are the Recognizer's on the same three utterances (the
    # same padded width)
    out = _decode(base, capsys, "--tpu-decode-batch=3",
                  "--tpu-decode-pad-last=True")
    batched = list(log2utt.parse_decode_log(io.StringIO(out)))
    assert sorted(u for u, _ in batched) == sorted(feats)
    order = [u for u, _ in batched]
    for start in range(0, len(order), 3):
        group = order[start:start + 3]
        got = recognizer.transcribe_batch([feats[u] for u in group],
                                          beam_width=20)
        assert [ids for ids, _ in got] == [dict(batched)[u] for u in group]
    # the host (C++) beam and greedy decode the same logits
    host = dict(log2utt.parse_decode_log(io.StringIO(
        _decode(base, capsys, "--tpu-decode-impl=host"))))
    assert host.keys() == hyps.keys()
    greedy = dict(log2utt.parse_decode_log(io.StringIO(
        _decode(base, capsys, "--tpu-decode-impl=greedy"))))
    for utt, x in feats.items():
        (ids, _), = recognizer.transcribe_batch([x], beam_width=1)
        assert greedy[utt] == ids
    # log2utt's CLI writes the trn file that score reads
    log = tmp_path / "decode.log"
    log.write_text(out)
    vocab = [line.strip() for line in open(VOCAB)]
    ref = tmp_path / "ref.trn"
    ref.write_text("".join("%s (%s)\n" % (log2utt.ids_to_utt(ids, vocab,
                                                              "timit"), utt)
                           for utt, ids in refs))
    capsys.readouterr()
    log2utt.main([str(log), VOCAB, "--corpus", "timit"])
    hyp = tmp_path / "hyp.trn"
    hyp.write_text(capsys.readouterr().out)
    report = io.StringIO()
    per = score.score(str(ref), str(hyp), out=report)
    assert "Utterances scored: %d (missing hyp: 0)" % len(refs) in \
        report.getvalue()
    assert np.isfinite(per) and per > 0.0  # a random model
    assert score.score(str(ref), str(ref), out=io.StringIO()) == 0.0


@pytest.mark.parametrize("flag", ["--train-is-mwer=True",
                                  "--tpu-decode-ema=True"])
def test_unported_trainer_modes_are_refused(corpus, flag, capsys):
    """Both flags were refused before the training extras were ported. In
    decode mode --train-is-mwer changes nothing (MWER is a way to train),
    and --tpu-decode-ema on a checkpoint trained without an EMA raises
    JAX's ValueError (tests/test_torch_train_extras.py decodes one with)."""
    base, _, _ = corpus
    if flag.startswith("--tpu-decode-ema"):
        with pytest.raises(ValueError, match="holds no EMA params"):
            trainer_sr.main(_argv(base, flag))
        return
    capsys.readouterr()
    trainer_sr.main(_argv(base, flag))
    assert "UTTID" in capsys.readouterr().out


def test_recognizer_beam_n_best_and_lm(corpus, tmp_path):
    base, feats, _ = corpus
    rng = np.random.RandomState(9)
    lm = ngram_lm.train_ngram([list(rng.randint(0, 62, size=12))
                               for _ in range(30)], 62, 3)
    lm.save(str(tmp_path / "lm.npz"))
    config = ParseOption(_argv(base, "--tpu-lm-path=%s" % (tmp_path / "lm.npz")),
                         LOGGER, is_print_opts=False).args
    recognizer = Recognizer(config, logger=LOGGER)
    assert recognizer.lm is not None and recognizer.lm[0].order == 3
    batch = [feats["utt00"], feats["utt03"]]
    top = recognizer.transcribe_batch_detailed(batch, beam_width=20)
    nbest = recognizer.transcribe_batch_detailed(batch, beam_width=20,
                                                 n_best=3)
    for one, many in zip(top, nbest):
        assert one["ids"] == many["ids"] and one["frames"] == many["frames"]
        assert len(many["nbest"]) == 3
        assert many["nbest"][0]["ids"] == one["ids"]
        scores = [h["score"] for h in many["nbest"]]
        assert scores == sorted(scores, reverse=True)
        assert len(one["token_confidences"]) == len(one["ids"])
        assert sorted(one["frames"]) == one["frames"]
    # --path-ckpt-epoch picks a step of the checkpoint directory
    config = ParseOption(_argv(base, "--path-ckpt=%s" % (base / "ckpt"),
                               "--path-ckpt-epoch=2"),
                         LOGGER, is_print_opts=False).args
    second = Recognizer(config, logger=LOGGER)
    step2 = checkpoint.CheckpointManager(str(base / "ckpt")).restore(2)
    assert all(torch.equal(second.model.state_dict()[k], v)
               for k, v in step2["model"].items())
    with pytest.raises(FileNotFoundError, match="no weights"):
        Recognizer(ParseOption(_argv(base, "--path-ckpt=%s" % tmp_path),
                               LOGGER, is_print_opts=False).args,
                   logger=LOGGER)
    assert convert  # weights also load from a flax .npz (test_torch_serve)


def test_recipe_stages_run_as_modules(corpus, tmp_path):
    """Stages 2-4 as the recipe runs them: ``python -m`` average_ckpt,
    trainer_sr decode mode, log2utt."""
    import subprocess
    import sys

    base, feats, _ = corpus
    env = dict(os.environ, PYTHONPATH=REPO)
    ckpt = tmp_path / "ckpt"
    manager = checkpoint.CheckpointManager(str(ckpt))
    for step in (1, 2):
        manager.save(step, checkpoint.CheckpointManager(
            str(base / "ckpt")).restore(step))

    def run(*argv):
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    run("srf_tpu_torch.tools.average_ckpt",
        *_argv(base, "--path-ckpt=%s" % ckpt, "--model-average-num=2")[1:])
    out = run("srf_tpu_torch.trainer_sr",
              *_argv(base, "--path-ckpt=%s" % (ckpt / "avg"))[1:])
    log = tmp_path / "decode.log"
    log.write_text(out)
    utt = run("srf_tpu_torch.utils.log2utt", str(log), VOCAB)
    lines = utt.strip().splitlines()
    assert sorted(line.rsplit("(", 1)[1].rstrip(")") for line in lines) == \
        sorted(feats)
