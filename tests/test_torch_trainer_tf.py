"""The STF and LSTM recipes' stages through the port's entry points on the
CPU (``--device=cpu``; a corpus of 14 synthetic utterances of 20-60 frames
written by ``tools.save_tfrecord``):

- ``python -m srf_tpu_torch.trainer_tf`` semantics through its ``main``:
  the pre-training validation pass, one epoch of training with the
  STF-TIMIT recipe's penalty and dropouts (L=2, D=8, 2 heads), then decode
  mode (``UTTID`` lines scraped by ``utils.log2utt``) after
  ``tools.average_ckpt`` over two epochs' checkpoints;
- its masked logits (padding bias and penalty board per batch) equal srf_tpu's
  ``make_logits_fn(make_apply_fn(model, make_stf_extra_kwargs(...)))`` on
  the same weights within atol 2e-5;
- the served STF (``Recognizer``) mirrors srf_tpu's ``Recognizer._apply``,
  which passes neither mask nor penalty: the port's served logits equal
  JAX's within 2e-5 and differ from the masked decode's (F17 in
  ROADMAP.md);
- ``trainer_sr`` trains a BLSTM with the CNN front end for 2 epochs,
  ``average_ckpt`` averages them and ``trainer_sr`` decodes the average;
- a pipeline or data mesh wider than the one process raises the
  ``ValueError`` naming the processes to launch, and
  ``--tpu-attention-kernel`` ring or a typo JAX's ``ValueError``.
"""

import io
import json
import logging

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.models.stf import ConvEncoder as FlaxConvEncoder
from srf_tpu.ops.attention_penalty import AttentionPenalty as JaxPenalty
from srf_tpu.serve import Recognizer as JaxRecognizer
from srf_tpu.config import ParseOption as JaxParseOption
from srf_tpu.train import step as jax_step
from srf_tpu.trainer_tf import make_stf_extra_kwargs as jax_extra_kwargs
from srf_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from srf_tpu_torch import convert, trainer_sr, trainer_tf
from srf_tpu_torch.config import ParseOption
from srf_tpu_torch.data.loader import EvalLoader, SpeechDataset
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops.attention_penalty import AttentionPenalty
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.tools import average_ckpt, save_tfrecord
from srf_tpu_torch.train.step import make_apply_fn, make_logits_fn
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils import checkpoint, log2utt

torch.set_num_threads(1)

FEAT_DIM = 8
VOCAB_TOKENS = ["<PADDING_SYMBOL>", "a", "b", "c", "<SPACE>", "$", "@"]
CLASS_N = len(VOCAB_TOKENS) + 1
QUIET = logging.getLogger("test_torch_trainer_tf")
QUIET.setLevel(logging.ERROR)
# train_stf_timit.sh's attention flags at a small width
STF_FLAGS = [
    "--model-type=stf", "--model-encoder-num=2", "--model-dimension=8",
    "--model-att-head-num=2", "--model-inner-dim=16",
    "--model-conv-layer-num=2", "--model-conv-filter-num=4",
    "--train-att-dropout=0.3", "--train-inn-dropout=0.4",
    "--train-inp-dropout=0.3", "--train-res-dropout=0.4",
    "--model-ap-scale=1", "--model-ap-width-zero=1",
    "--model-ap-width-stripe=1", "--model-ap-encoder=True",
    "--model-ap-decoder=True", "--model-ap-encdec=False",
]
# train_lstm_wsj.sh's model at a small width
LSTM_FLAGS = [
    "--model-type=blstm", "--model-encoder-num=2", "--model-dimension=6",
    "--model-lstm-is-cnnfe=True", "--model-conv-layer-num=2",
    "--model-conv-filter-num=4", "--train-inn-dropout=0.4",
    "--train-inp-dropout=0.3",
]


def _make_corpus(base):
    rng = np.random.RandomState(0)
    (base / "test.vocab").write_text("\n".join(VOCAB_TOKENS) + "\n")
    utts = []
    for i in range(14):
        n_frames = int(rng.randint(20, 60))
        np.save(base / ("utt%02d.None.npy" % i),
                rng.randn(n_frames, FEAT_DIM).astype(np.float32))
        text = "".join(rng.choice(list("abc"), size=rng.randint(2, 5)))
        utts.append({"key": "utt%02d.None.npy" % i,
                     "duration": n_frames / 100.0, "text": text})
    for split, sel in (("train", utts[:10]), ("valid", utts[10:12]),
                       ("test", utts[12:])):
        with open(base / ("%s.json" % split), "w") as f:
            for utt in sel:
                f.write(json.dumps(utt) + "\n")


def _argv(base, ckpt, *extra):
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
        "--path-ckpt=%s" % ckpt, "--device=cpu",
        "--train-opti-type=adam", "--train-lr-param-k=0.01",
        "--train-batch-dynamic=False", "--train-batch-size=2",
        "--train-es-tolerance=100", "--model-ckpt-max-to-keep=-1",
        "--decoding-beam-width=4", *extra,
    ]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_tf")
    _make_corpus(base)
    save_tfrecord.main(_argv(base, base / "unused"))
    return base


@pytest.fixture(scope="module")
def stf_ckpt(corpus):
    """Two epochs of trainer_tf (the log of its first run kept)."""
    ckpt = corpus / "stf_ckpt"
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logger = logging.getLogger("srf_tpu_torch")  # the trainer's
    logger.addHandler(handler)
    try:
        trainer_tf.main(_argv(corpus, ckpt, *STF_FLAGS,
                              "--train-max-epoch=1"))
    finally:
        logger.removeHandler(handler)
    trainer_tf.main(_argv(corpus, ckpt, *STF_FLAGS, "--train-max-epoch=2"))
    return ckpt, log.getvalue()


def _decode(argv_fn, main, corpus, ckpt, flags, capsys):
    capsys.readouterr()
    main(argv_fn(corpus, ckpt, *flags, "--train-max-epoch=0"))
    hyps = dict(log2utt.parse_decode_log(io.StringIO(capsys.readouterr().out)))
    assert set(hyps) == {"utt12", "utt13"}
    assert all(0 <= i < len(VOCAB_TOKENS) for ids in hyps.values()
               for i in ids)
    return hyps


def test_trainer_tf_trains_averages_and_decodes(corpus, stf_ckpt, capsys):
    ckpt, log = stf_ckpt
    assert "Pre-training Valid Loss" in log
    assert "Attention penalty: zero width 1, stripe width 1" in log
    manager = checkpoint.CheckpointManager(str(ckpt))
    assert manager.all_steps() == [1, 2]
    assert manager.restore(2)["step"] == 10  # 5 batches of 2 an epoch
    records = [json.loads(line) for line in open(ckpt / "metrics.jsonl")]
    assert [r["kind"] for r in records] == ["train_epoch", "valid_epoch"] * 2
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in records)
    average_ckpt.main(_argv(corpus, ckpt, *STF_FLAGS,
                            "--model-average-num=2"))
    _decode(_argv, trainer_tf.main, corpus, ckpt / "avg", STF_FLAGS, capsys)


def _config(corpus, ckpt, *flags):
    return ParseOption(_argv(corpus, ckpt, *flags), QUIET,
                       is_print_opts=False).args


def _test_batches(corpus):
    dataset = SpeechDataset(
        str(corpus / "tfrecord/synth-test-None-8-*-of-*"), FEAT_DIM, 0, 0,
        with_utt_id=True)
    return list(EvalLoader(dataset, batch_size=2))


def test_masked_logits_match_jax_and_serving_is_unmasked(corpus, stf_ckpt):
    ckpt, _ = stf_ckpt
    config = _config(corpus, ckpt, *STF_FLAGS)
    state = checkpoint.CheckpointManager(str(ckpt)).restore(2)["model"]
    variables = convert.state_dict_to_flax(state)
    model, div = build_model(config, CLASS_N)
    model.load_state_dict(state)
    logits_fn = make_logits_fn(make_apply_fn(
        model, trainer_tf.make_stf_extra_kwargs(
            AttentionPenalty(2500, 2, 1, 1, 1.0), div)))
    flax_model = FlaxConvEncoder.from_config(config, CLASS_N)
    jax_logits_fn = jax_step.make_logits_fn(jax_step.make_apply_fn(
        flax_model, jax_extra_kwargs(JaxPenalty(2500, 2, 1, 1, 1.0), div)))
    jax_state = TrainStateView(variables)
    batch, = _test_batches(corpus)
    lengths = batch["inp_len"]
    assert lengths.min() < lengths.max()  # one utterance is padded
    got = logits_fn(TrainState(model=model, optimizer=None,
                               device=torch.device("cpu")), batch).numpy()
    want = np.asarray(jax_logits_fn(jax_state, {
        k: jnp.asarray(batch[k]) for k in ("feats", "inp_len")}))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)

    # served: the JAX Recognizer applies the model without mask or penalty
    manager = JaxCheckpointManager(str(corpus / "jax_ckpt"))
    manager.save(1, {"step": np.asarray(1, np.int32),
                     "params": variables["params"],
                     "batch_stats": variables["batch_stats"]})
    manager.close()
    argv = _argv(corpus, corpus / "jax_ckpt", *STF_FLAGS)
    jax_rec = JaxRecognizer(JaxParseOption(
        [a for a in argv if a != "--device=cpu"], QUIET,
        is_print_opts=False).args, logger=QUIET)
    rec = Recognizer(config, state_dict=state, device="cpu", logger=QUIET)
    feats_list = [batch["feats"][i, :n] for i, n in enumerate(lengths)]
    feats, lens = rec.pad(feats_list)
    served = rec.forward(feats, lens).numpy()
    assert feats.shape[1] == 128  # both pad to a multiple of 128 frames
    want_served = np.asarray(jax_rec._apply(
        jax_rec.state.params, jax_rec.state.batch_stats,
        jnp.asarray(feats.numpy()), jnp.asarray(lens)))
    np.testing.assert_allclose(served, want_served, rtol=0, atol=2e-5)
    short = int(np.argmin(lengths))
    frames = -(-int(lengths[short]) // div)
    assert np.abs(served[short, :frames] - got[short, :frames]).max() > 1e-3
    ids = rec.transcribe_batch(feats_list, beam_width=4)
    assert [i for i, _ in ids] == [i for i, _ in jax_rec.transcribe_batch(
        feats_list, beam_width=4)]


class TrainStateView:
    """The two fields srf_tpu's ``make_logits_fn`` reads."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.batch_stats = variables["batch_stats"]


def test_blstm_through_trainer_sr_and_average(corpus, capsys):
    ckpt = corpus / "lstm_ckpt"
    trainer_sr.main(_argv(corpus, ckpt, *LSTM_FLAGS, "--train-max-epoch=2"))
    manager = checkpoint.CheckpointManager(str(ckpt))
    assert manager.all_steps() == [1, 2]
    saved = manager.restore(2)
    assert saved["model"]["lstm0.weight_ih_l0_reverse"].shape == (24, 8)
    assert not saved["model"]["lstm1.bias_ih_l0"].any()
    average_ckpt.main(_argv(corpus, ckpt, *LSTM_FLAGS,
                            "--model-average-num=2"))
    avg = checkpoint.CheckpointManager(str(ckpt / "avg")).restore(1)["model"]
    first = manager.restore(1)["model"]
    want = ((first["lstm0.weight_hh_l0"].double()
             + saved["model"]["lstm0.weight_hh_l0"].double()) / 2).float()
    assert torch.equal(avg["lstm0.weight_hh_l0"], want)
    _decode(_argv, trainer_sr.main, corpus, ckpt / "avg", LSTM_FLAGS, capsys)


@pytest.mark.parametrize("flag,item", [
    ("--tpu-pipeline-stages=2", 7), ("--tpu-fsdp=True", 7),
    ("--tpu-mesh-data=2", 7), ("--tpu-bf16=True", 5),
    ("--tpu-specaug=True", 5), ("--tpu-ema-decay=0.999", 5),
    ("--tpu-grad-accum=2", 5)])
def test_trainer_tf_refusals(corpus, tmp_path, flag, item):
    """Nothing is refused any more. Item 5's flags (the training extras)
    and item 7's ``--tpu-fsdp`` train the STF for an epoch in one process;
    a pipeline of 2 stages or a data mesh of 2 in one process raises the
    ValueError that names the processes to launch
    (tests/test_torch_pipeline.py runs them on 2 ranks)."""
    if flag in ("--tpu-pipeline-stages=2", "--tpu-mesh-data=2"):
        with pytest.raises(ValueError, match="launch 2 processes"):
            trainer_tf.main(_argv(corpus, tmp_path, *STF_FLAGS, flag,
                                  "--train-max-epoch=1"))
        return
    trainer_tf.main(_argv(corpus, tmp_path, *STF_FLAGS, flag,
                          "--train-max-epoch=1"))
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records and all(np.isfinite(r["loss"]) for r in records)


@pytest.mark.parametrize("kernel", ["ring", "typo"])
def test_attention_kernel_errors(corpus, tmp_path, kernel):
    with pytest.raises(ValueError, match="ring|unknown"):
        trainer_tf.main(_argv(corpus, tmp_path, *STF_FLAGS,
                              "--tpu-attention-kernel=" + kernel,
                              "--train-max-epoch=1"))
