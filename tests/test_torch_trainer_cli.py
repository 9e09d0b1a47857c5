"""The recipe's stages 0-4 through the port's entry points on the CPU
(``--device=cpu``, a small SRF): the counterpart of
``tests/test_e2e.py::test_train_decode_cycle``.

- ``srf_tpu_torch.data.writer`` / ``tools.save_tfrecord`` write shards
  byte-equal to ``srf_tpu.data.writer``'s for the same npy + JSON corpus
  (train shards after the same seeded shuffle; the CLI's unseeded shuffle
  keeps the same records), and skip a split whose shards exist;
- ``trainer_sr`` trains 2 epochs, resumes to 3 from the checkpoint (epoch
  offset 2, no epoch retrained; that epoch profiled into a Chrome trace by
  ``--tpu-profile-dir``, which holds the feed's and the step's spans),
  averages with ``tools.average_ckpt``, decodes and is scraped by
  ``utils.log2utt``;
- ``python -m srf_tpu_torch.trainer_sr`` exits 42 under
  ``--tpu-fault-at-step``, 143 under ``--tpu-fault-signal-at-step`` (a
  SIGTERM: the mid checkpoint saved at that step) and 43 under
  ``--tpu-fault-hang-at-step`` (the watchdog), each after a mid-epoch
  checkpoint the rerun resumes from; averaging ignores ``mid/``;
- train mode without ``--device=cpu`` on a machine without a card raises.
"""

import io
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from srf_tpu.config import ParseOption as JaxParseOption
from srf_tpu.config.constants import Tag
from srf_tpu.data import writer as jax_writer
from srf_tpu_torch import trainer_sr
from srf_tpu_torch.config import ParseOption
from srf_tpu_torch.data import writer
from srf_tpu_torch.data.tfrecord import read_records
from srf_tpu_torch.tools import average_ckpt, save_tfrecord
from srf_tpu_torch.tools.supervise import DEFAULT_RESTART_CODES, should_restart
from srf_tpu_torch.utils import checkpoint, log2utt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_DIM = 8
VOCAB_TOKENS = ["<PADDING_SYMBOL>", "a", "b", "c", "<SPACE>", "$", "@"]
QUIET = logging.getLogger("test_torch_trainer_cli")
QUIET.setLevel(logging.ERROR)


def _make_corpus(base):
    rng = np.random.RandomState(0)
    (base / "test.vocab").write_text("\n".join(VOCAB_TOKENS) + "\n")
    utts = []
    for i in range(14):
        n_frames = int(rng.randint(12, 30))
        np.save(base / ("utt%02d.None.npy" % i),
                rng.randn(n_frames, FEAT_DIM).astype(np.float32))
        text = "".join(rng.choice(list("abc"), size=rng.randint(2, 5)))
        utts.append({"key": "utt%02d.None.npy" % i,
                     "duration": n_frames / 100.0,
                     "text": text})
    for split, sel in (("train", utts[:10]), ("valid", utts[10:12]),
                       ("test", utts[12:])):
        with open(base / ("%s.json" % split), "w") as f:
            for utt in sel:
                f.write(json.dumps(utt) + "\n")


def _argv(base, *extra):
    return [
        "prog", "--path-base=%s" % base, "--path-vocab=test.vocab",
        "--feat-dim=%d" % FEAT_DIM, "--feat-type=None",
        "--prep-data-name=synth", "--prep-data-shard=2",
        "--path-train-json=train.json", "--path-valid-json=valid.json",
        "--path-test-json=test.json", "--path-wrt-tfrecord=tfrecord",
        "--decoding-from-npy=True",
        "--path-train-ptrn=tfrecord/synth-train-None-8-*-of-*",
        "--path-valid-ptrn=tfrecord/synth-valid-None-8-*-of-*",
        "--path-test-ptrn=tfrecord/synth-test-None-8-*-of-*",
        "--path-ckpt=%s" % (base / "ckpt"), "--device=cpu",
        # the verify skill's small SRF
        "--model-type=srf", "--model-caps-type=naive",
        "--model-caps-context=True", "--model-encoder-num=3",
        "--model-caps-primary-num=8", "--model-caps-primary-dim=4",
        "--model-caps-convolution-num=6", "--model-caps-convolution-dim=4",
        "--model-caps-class-dim=4", "--model-caps-iter=1",
        "--model-caps-window-lpad=1", "--model-caps-window-rpad=1",
        "--model-conv-layer-num=2", "--model-conv-filter-num=8",
        "--train-opti-type=adam", "--train-lr-param-k=0.02",
        "--train-batch-dynamic=False", "--train-batch-size=2",
        "--train-es-tolerance=100", "--model-ckpt-max-to-keep=-1",
        "--decoding-beam-width=4", *extra,
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_cli")
    _make_corpus(base)
    save_tfrecord.main(_argv(base))
    return base


def test_writer_shards_are_byte_equal_to_jax(corpus):
    trees = {}
    for name, module, parse in (("jax", jax_writer, JaxParseOption),
                                ("torch", writer, ParseOption)):
        out = corpus / ("written_by_" + name)  # relative to --path-base
        argv = [a for a in _argv(corpus, "--path-wrt-tfrecord=" + out.name)
                if a != "--device=cpu"]  # a flag of the port's own
        config = parse(argv, QUIET, is_print_opts=False).args
        paths, count = module.convert_to_tfrecord(QUIET, config, Tag.TRAIN,
                                                  None)
        assert count == 10 and len(paths) == 2
        for tag in (Tag.VALID, Tag.TEST):
            module.convert_to_tfrecord(QUIET, config, tag, None)
        for path in paths:
            module.shuffle_records(path, seed=3)
        # every shard exists: the split is skipped
        again, count = module.convert_to_tfrecord(QUIET, config, Tag.TRAIN,
                                                  None)
        assert count == 0 and again == paths
        trees[name] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert sorted(trees["torch"]) == sorted(trees["jax"])
    assert len(trees["torch"]) == 4
    assert not any(name.endswith((".incomplete", ".shuffling"))
                   for name in trees["torch"])
    for name, data in trees["jax"].items():
        assert trees["torch"][name] == data, name
    # the CLI (stage 0): valid and test byte-equal, train shards holding
    # the same records in its unseeded order
    written = corpus / "tfrecord"
    for name, data in trees["jax"].items():
        cli = (written / name).read_bytes()
        if "-train-" in name:
            assert sorted(read_records(str(written / name))) == sorted(
                read_records(str(corpus / "written_by_jax" / name)))
        else:
            assert cli == data, name


def test_train_resume_average_decode_cycle(corpus, capsys, tmp_path):
    ckpt = corpus / "ckpt"
    trainer_sr.main(_argv(corpus, "--train-max-epoch=2"))
    manager = checkpoint.CheckpointManager(str(ckpt))
    assert manager.all_steps() == [1, 2]
    first = manager.restore(2)
    assert first["step"] == 10  # 5 batches of 2 an epoch
    # resume for one more epoch: offset 2 from the checkpoint's step; its
    # first trained epoch profiled (a Chrome trace)
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logger = logging.getLogger("srf_tpu_torch")  # the trainer's
    logger.addHandler(handler)
    try:
        trainer_sr.main(_argv(corpus, "--train-max-epoch=3",
                              "--tpu-profile-dir=%s" % tmp_path))
    finally:
        logger.removeHandler(handler)
    assert "Loaded ckpt: %s/2" % ckpt in log.getvalue()
    trace, = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"srf.feed", "srf.feed.load", "srf.feed.put", "srf.step",
            "srf.step.forward", "srf.step.loss", "srf.step.backward",
            "srf.step.optimizer"} <= names
    assert manager.all_steps() == [1, 2, 3]
    assert manager.restore(3)["step"] == 15
    records = [json.loads(line) for line in open(ckpt / "metrics.jsonl")]
    assert [r["epoch"] for r in records if r["kind"] == "train_epoch"] == [
        1, 2, 3]
    assert [r["kind"] for r in records] == ["train_epoch", "valid_epoch"] * 3
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in records)
    # stage 2-4: average, decode, scrape
    average_ckpt.main(_argv(corpus, "--model-average-num=2"))
    capsys.readouterr()
    trainer_sr.main(_argv(corpus, "--train-max-epoch=0",
                          "--path-ckpt=%s" % (ckpt / "avg")))
    out = capsys.readouterr().out
    hyps = dict(log2utt.parse_decode_log(io.StringIO(out)))
    assert set(hyps) == {"utt12", "utt13"}
    assert all(0 <= i < len(VOCAB_TOKENS) for ids in hyps.values()
               for i in ids)


@pytest.fixture(scope="module")
def one_epoch(corpus, tmp_path_factory):
    """A checkpoint directory after one epoch (5 steps)."""
    ckpt = tmp_path_factory.mktemp("one_epoch") / "ckpt"
    trainer_sr.main(_argv(corpus, "--path-ckpt=%s" % ckpt,
                          "--train-max-epoch=1"))
    return ckpt


@pytest.mark.parametrize("fault,code,message", [
    (("--tpu-fault-at-step=9",), 42, "FAULT INJECTION: hard-exit"),
    (("--tpu-fault-signal-at-step=9",), 143, "SIGTERM: saved mid-epoch"),
    # the watchdog's timeout stays well above a step's time on a loaded
    # machine (one thread: the subprocess does not compete with itself)
    (("--tpu-fault-hang-at-step=9", "--tpu-watchdog-secs=5"), 43,
     "WATCHDOG: no training progress")])
def test_fault_exits_and_the_rerun_resumes_mid_epoch(
        corpus, one_epoch, tmp_path, fault, code, message):
    """Each failure exit the supervisor restarts on (tools/supervise.py)
    leaves a mid-epoch checkpoint at step 9, epoch 2's 4th batch, that the
    rerun resumes from."""
    shutil.copytree(one_epoch, tmp_path / "ckpt")
    flags = _argv(corpus, "--path-ckpt=%s" % (tmp_path / "ckpt"),
                  "--train-max-epoch=3", "--tpu-ckpt-every-steps=2")[1:]
    proc = subprocess.run(
        [sys.executable, "-m", "srf_tpu_torch.trainer_sr", *flags, *fault],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == code, proc.stderr[-3000:]
    assert message in proc.stderr
    assert should_restart(proc.returncode, DEFAULT_RESTART_CODES)
    mid = checkpoint.CheckpointManager(str(tmp_path / "ckpt" / "mid"))
    # epoch 2 starts at step 5: mids after its 2nd and 4th batches
    assert mid.all_steps() == [7, 9]
    assert mid.restore(9)["resume"]["batch_index"] == 4
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logger = logging.getLogger("srf_tpu_torch")  # the trainer's
    logger.addHandler(handler)
    try:
        trainer_sr.main(["prog", *flags])
    finally:
        logger.removeHandler(handler)
    assert "Resuming mid-epoch" in log.getvalue()
    assert "epoch 1, batch 4" in log.getvalue()
    manager = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    assert manager.all_steps() == [1, 2, 3]
    assert manager.restore(3)["step"] == 15
    # averaging reads the numbered steps only, not mid/
    assert checkpoint.average_checkpoints(str(tmp_path / "ckpt"), 10)[1] == [
        1, 2, 3]


def test_train_mode_needs_the_card_unless_the_cpu_is_asked(corpus,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(corpus, "--train-max-epoch=1")
            if a != "--device=cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_sr.main(argv)


@pytest.mark.parametrize("flag", [
    "--train-is-mwer=True", "--tpu-ema-decay=0.99", "--tpu-grad-accum=2",
    "--tpu-bf16=True", "--tpu-specaug=True", "--tpu-fsdp=True",
    "--tpu-async-ckpt=True", "--tpu-mesh-data=2"])
def test_training_extras_are_refused(corpus, tmp_path, flag):
    """Nothing is refused any more. The training extras and, in one
    process, ``--tpu-fsdp`` (nothing to shard, as JAX's on one device) and
    ``--tpu-async-ckpt`` each train an epoch with finite losses (an EMA
    run's checkpoint holds its "ema"); ``--tpu-mesh-data=2`` in one
    process raises JAX's ValueError, naming the processes to launch
    (tests/test_torch_distributed.py runs two)."""
    argv = _argv(corpus, "--train-max-epoch=1", flag,
                 "--path-ckpt=%s" % tmp_path)
    if flag == "--tpu-mesh-data=2":
        with pytest.raises(ValueError, match="launch 2 processes"):
            trainer_sr.main(argv)
        return
    trainer_sr.main(argv)
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    tree = checkpoint.CheckpointManager(str(tmp_path)).restore(1)
    assert ("ema" in tree) == flag.startswith("--tpu-ema-decay")


def test_extras_train_average_and_decode_with_ema(corpus, tmp_path, capsys):
    """Stages 1-4 with the training extras together: two epochs with
    accumulation, EMA and SpecAugment, averaging (the EMA averaged too) and
    a decode of the averaged EMA weights (--tpu-decode-ema)."""
    extras = ("--tpu-grad-accum=2", "--tpu-ema-decay=0.9",
              "--tpu-specaug=True", "--path-ckpt=%s" % tmp_path)
    trainer_sr.main(_argv(corpus, "--train-max-epoch=2", *extras))
    manager = checkpoint.CheckpointManager(str(tmp_path))
    trees = [manager.restore(step) for step in (1, 2)]
    assert all(set(t["ema"]) == set(trees[0]["ema"]) for t in trees)
    average_ckpt.main(_argv(corpus, "--model-average-num=2", *extras))
    avg = checkpoint.CheckpointManager(str(tmp_path / "avg")).restore(1)
    name = sorted(avg["ema"])[0]
    want = ((trees[0]["ema"][name].double() + trees[1]["ema"][name].double())
            / 2).float()
    assert torch.equal(avg["ema"][name], want)
    capsys.readouterr()
    trainer_sr.main(_argv(corpus, "--train-max-epoch=0",
                          "--tpu-decode-ema=True",
                          "--path-ckpt=%s" % (tmp_path / "avg")))
    hyps = dict(log2utt.parse_decode_log(io.StringIO(capsys.readouterr().out)))
    assert set(hyps) == {"utt12", "utt13"}
