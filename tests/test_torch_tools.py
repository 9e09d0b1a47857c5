"""The port's tools and small utils against the JAX package's, on the same
inputs: ``tools.{make_vocab, ark_to_npy, make_ref, train_ngram_lm,
ckpt_info, import_tf_ckpt}`` and ``utils.{flops, misc, plotting}``.

The files the tools write are byte-equal (vocab, npy, the sclite
reference) or array-equal (the LM's compressed ``.npz``) to the JAX tools'
on the same inputs; ``ckpt_info`` prints JAX's report on the port's
``torch.save`` checkpoint of the same tree; the FLOP counters return JAX's
counts to the bit (only the peaks differ: the H100's in place of the
v5e's). The TF checkpoint readers of ``import_tf_ckpt`` take a dict-backed
reader here (a real TF checkpoint is ``test_torch_import_tf.py``'s).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import srf_tpu.utils.flops as jax_flops
from srf_tpu.models.cnn import CNNEncoder as FlaxCNNEncoder
from srf_tpu.models.cnn import CNNStrideEncoder as FlaxCNNStrideEncoder
from srf_tpu.models.lstm import LstmEncoder as FlaxLstmEncoder
from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.models.stf import ConvEncoder as FlaxConvEncoder
from srf_tpu.tools import ark_to_npy as jax_ark_to_npy
from srf_tpu.tools import ckpt_info as jax_ckpt_info
from srf_tpu.tools import import_tf_ckpt as jax_import
from srf_tpu.tools import make_ref as jax_make_ref
from srf_tpu.tools import make_vocab as jax_make_vocab
from srf_tpu.tools import train_ngram_lm as jax_train_ngram_lm
from srf_tpu.utils import misc as jax_misc
from srf_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from srf_tpu_torch import convert
from srf_tpu_torch.data.example_proto import encode_example
from srf_tpu_torch.data.tfrecord import TFRecordWriter
from srf_tpu_torch.models.cnn import CNNEncoder, CNNStrideEncoder
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.tools import (ark_to_npy, ckpt_info, import_tf_ckpt,
                                 make_ref, make_vocab, train_ngram_lm)
from srf_tpu_torch.utils import flops, misc, plotting
from srf_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_parity import (DictReader, flatten_tree, random_flax_variables,
                           reference_names)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMIT_VOCAB = os.path.join(REPO, "egs", "data", "timit_62.vocab")
WSJ_VOCAB = os.path.join(REPO, "egs", "data", "wsj_31.vocab")
TEXTS = ("abc ab", "bb", "cab a", "a c", "ccc b a")


def _manifest(path, texts=TEXTS):
    with open(path, "w") as f:
        for i, text in enumerate(texts):
            f.write(json.dumps({"key": "utt%d" % i, "duration": 1.0,
                                "text": text}) + "\n")
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--min-count=3"],
                                   ["--unit", "token"]])
def test_make_vocab_writes_jax_bytes(tmp_path, capsys, extra):
    manifest = _manifest(tmp_path / "train.json")
    outputs = []
    for tool, name in ((jax_make_vocab, "jax.vocab"),
                       (make_vocab, "port.vocab")):
        assert tool.main([str(tmp_path / name), manifest, *extra]) == 0
        outputs.append(capsys.readouterr().out.replace(name, "out"))
    assert ((tmp_path / "port.vocab").read_bytes()
            == (tmp_path / "jax.vocab").read_bytes())
    assert outputs[0] == outputs[1]


ARK = """utt_a  [
  1.5 -2 3e-1
  4 5 6 ]
utt_b [ 7 8 9
  10 11 12
 ]
utt_empty [
 ]
"""


def test_ark_to_npy_writes_jax_files(tmp_path):
    ark = tmp_path / "feats.txt"
    ark.write_text(ARK)
    assert jax_ark_to_npy.convert(str(ark), str(tmp_path / "jax")) == 3
    assert ark_to_npy.main([str(ark), "--outdir",
                            str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "utt_a.npy", "utt_b.npy", "utt_empty.npy"]
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    with pytest.raises(ValueError, match="inside utterance"):
        list(ark_to_npy.parse_ark(["u [", "1 2"]))


@pytest.mark.parametrize("corpus,vocab", [("timit", TIMIT_VOCAB),
                                          ("wsj", WSJ_VOCAB)])
def test_make_ref_prints_jax_lines(tmp_path, capsys, corpus, vocab):
    """sclite references from TFRecords the port's writer wrote (2
    shards): the same lines as JAX's make_ref."""
    rng = np.random.RandomState(0)
    n_symbols = sum(1 for _ in open(vocab))
    for shard in range(2):
        with TFRecordWriter(str(tmp_path / ("test-%d.tfrecord" % shard))) as w:
            for i in range(3):
                labels = rng.randint(1, n_symbols - 2, size=rng.randint(2, 9))
                w.write(encode_example({
                    "feats": rng.randn(5, 3).astype(np.float32),
                    "target_label": labels.astype(np.int64),
                    "utt_id": "spk%d-utt%d" % (shard, i),
                }))
    argv = [str(tmp_path / "test-*.tfrecord"), vocab, "--corpus", corpus]
    printed = []
    for tool in (jax_make_ref, make_ref):
        tool.main(argv)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert len(printed[1].splitlines()) == 6


def test_train_ngram_lm_writes_jax_tables(tmp_path):
    vocab = tmp_path / "tiny.vocab"
    vocab.write_text("<PADDING_SYMBOL>\na\nb\nc\n<SPACE>\n$\n@\n")
    _manifest(tmp_path / "train.json")
    tables = []
    for tool, name in ((jax_train_ngram_lm, "jax.npz"),
                       (train_ngram_lm, "port.npz")):
        tool.main(["train_ngram_lm", "--path-base=%s" % tmp_path,
                   "--path-vocab=tiny.vocab", "--path-train-json=train.json",
                   "--prep-data-unit=char", "--tpu-lm-order=3",
                   "--tpu-lm-out=%s" % (tmp_path / name)])
        with np.load(tmp_path / name) as data:
            tables.append({k: data[k] for k in data.files})
    assert sorted(tables[0]) == sorted(tables[1]) == ["meta", "table"]
    for key in tables[0]:
        np.testing.assert_array_equal(tables[1][key], tables[0][key])


def test_ckpt_info_prints_jax_report(tmp_path):
    """The same tree saved by JAX's orbax manager and by the port's
    CheckpointManager, the EMA under each package's key (``ema_params``,
    ``ema``): the port's report is JAX's line for line (the directory and
    that key aside), and carries the lines JAX's own test checks."""
    tree = {"step": np.asarray(3, np.int32),
            "params": {"w": np.zeros((4, 5), np.float32),
                       "b": np.zeros((5,), np.float32)},
            "ema_params": {"w": np.zeros((4, 5), np.float32)}}
    jax_manager = JaxCheckpointManager(str(tmp_path / "jax"))
    jax_manager.save(3, tree)
    jax_manager.close()
    CheckpointManager(str(tmp_path / "port")).save(3, {
        "step": torch.tensor(3, dtype=torch.int32),
        "params": {k: torch.from_numpy(v)
                   for k, v in tree["params"].items()},
        "ema": {"w": torch.zeros(4, 5)}})
    reports = []
    for tool, name in ((jax_ckpt_info, "jax"), (ckpt_info, "port")):
        buf = io.StringIO()
        assert tool.describe(str(tmp_path / name), full=True, out=buf) == 0
        text = buf.getvalue().replace(str(tmp_path / name), "DIR")
        reports.append([line.replace("ema_params", "ema").split()
                        for line in text.splitlines()])
    assert reports[1] == reports[0]
    text = buf.getvalue()
    assert "steps on disk:  3" in text
    assert "params" in text and "25 params" in text
    assert "present (serve with --tpu-decode-ema)" in text
    assert "4x5" in text


def test_ckpt_info_on_a_trainer_checkpoint(tmp_path, capsys):
    """A checkpoint as trainer_sr writes it (model, optimizer, scheduler,
    EMA): every subtree counted, the EMA found, through the CLI."""
    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.Adam(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    optimizer.step()
    manager = CheckpointManager(str(tmp_path))
    for step in (1, 2):
        manager.save(step, {"step": step, "model": model.state_dict(),
                            "optimizer": optimizer.state_dict(),
                            "scheduler": None,
                            "ema": dict(model.named_parameters())})
    assert ckpt_info.main([str(tmp_path), "--step=1"]) == 0
    text = capsys.readouterr().out
    assert "steps on disk:  1, 2" in text and "step 1" in text
    assert "model" in text and "8 params" in text
    assert "optimizer" in text and "EMA weights:    present" in text
    assert ckpt_info.main([str(tmp_path / "none")]) == 1


FLOPS_GRID = [(1, 100), (29, 241), (8, 1664), (3, 17)]


@pytest.mark.parametrize("batch,frames", FLOPS_GRID)
def test_flops_equal_jax_counts(batch, frames):
    calls = [
        ("srf_forward_flops", dict(
            feat_dim=123, enc_num=7, ph=60, pd=8, ch=30, cd=8, class_n=63,
            vd=8, lpad=1, rpad=1, num_iter=1)),
        ("srf_forward_flops", dict(
            feat_dim=123, enc_num=1, ph=6, pd=4, ch=5, cd=4, class_n=9,
            vd=3, lpad=2, rpad=0, num_iter=3, conv_layer_num=3,
            conv_filter_num=8, stride=3)),
        ("srf_train_step_flops", dict(
            feat_dim=123, enc_num=10, ph=60, pd=20, ch=30, cd=20,
            class_n=32, vd=20, lpad=2, rpad=2, num_iter=1)),
        ("stf_forward_flops", dict(
            feat_dim=123, num_layers=20, d_model=128, num_heads=4, dff=1024,
            vocab_n=63)),
        ("lstm_forward_flops", dict(
            feat_dim=123, num_layers=5, d_model=534, vocab_n=32)),
        ("lstm_forward_flops", dict(
            feat_dim=123, num_layers=2, d_model=16, vocab_n=9,
            bidirectional=False, is_cnnfe=False)),
        ("cnn_maxpool_forward_flops", dict(
            feat_dim=123, enc_num=10, class_n=63, nfilt_inp=128,
            nfilt_inn=256, proj_layers=3, proj_dim=1024)),
        ("cnn_stride_forward_flops", dict(
            feat_dim=123, enc_num=15, class_n=32, nfilt_inp=200,
            nfilt_inn=430, proj_layers=3, proj_dim=2048)),
    ]
    for name, kwargs in calls:
        got = getattr(flops, name)(batch, frames, **kwargs)
        assert got == getattr(jax_flops, name)(batch, frames, **kwargs) > 0
    assert (flops.conv2d_flops(batch, frames, 5, 7, 3, 3, 2)
            == jax_flops.conv2d_flops(batch, frames, 5, 7, 3, 3, 2))


def test_mfu_takes_the_h100_peak_of_the_step_dtype():
    assert (flops.H100_PEAK_BF16, flops.H100_PEAK_FP32) == (989.4e12,
                                                            66.9e12)
    assert flops.mfu(66.9e12, 2.0, flops.H100_PEAK_FP32) == 0.5
    assert flops.mfu(989.4e12, 4.0, flops.H100_PEAK_BF16) == 0.25
    with pytest.raises(TypeError):
        flops.mfu(1.0, 1.0)  # no default peak: the caller names its dtype


def test_misc_matches_jax(tmp_path, capsys):
    items = list(range(40))
    for seed in (0, 7, 1234):
        assert misc.shuffle_data(items, seed) == jax_misc.shuffle_data(
            items, seed)
    path = tmp_path / "lines.txt"
    path.write_text("a\nb\nc\n")
    assert misc.get_file_line(str(path)) == jax_misc.get_file_line(
        str(path)) == 3
    assert misc.all_exist([str(path)]) and not misc.all_exist(
        [str(path), str(tmp_path / "missing")])
    misc.make_dir(str(tmp_path / "d" / "e"))
    assert os.path.isdir(tmp_path / "d" / "e")
    printed = []
    for module in (jax_misc, misc):
        module.print_progress(3, 3, prefix="p", bar_len=10)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[1].endswith("\n")


def test_plotting_writes_a_png(tmp_path):
    weights = torch.softmax(torch.randn(2, 3, 6, 6), dim=-1)  # [B, H, Q, K]
    out = plotting.plot_attention_weights(weights, str(tmp_path / "a.png"))
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _family_models(family):
    """(flax model, port model, reader call, layer count) per family at a
    small width."""
    if family in ("srf_naive", "srf_lowmemory"):
        kw = dict(feat_dim=123, class_n=9, enc_num=3, caps_primary_num=6,
                  caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
                  caps_class_dim=4, caps_iter=1, lpad=1, rpad=1,
                  is_context=True, conv_filter_num=8,
                  caps_type=family[4:])
        return (FlaxSequenceRouter(**kw), SequenceRouter(**kw),
                lambda m, r: m.read_srf_params(r), 3)
    if family == "stf":
        kw = dict(num_layers=2, d_model=16, num_heads=2, dff=32,
                  feat_dim=123, vocab_n=9, nfilt=8)
        init_args = (np.zeros((1, 8, 123), np.float32),
                     np.full((1,), 8, np.int32), False)
        return (FlaxConvEncoder(**kw), ConvEncoder(**kw),
                lambda m, r: m.read_stf_params(r), 2, init_args)
    if family in ("lstm", "blstm"):
        kw = dict(num_layers=2, d_model=8, vocab_n=9, feat_dim=123,
                  bidirectional=family == "blstm", is_cnnfe=True,
                  conv_filter_num=4)
        return (FlaxLstmEncoder(**kw), LstmEncoder(**kw),
                lambda m, r: m.read_lstm_params(
                    r, bidirectional=family == "blstm", units=8), 2)
    kw = dict(enc_num=6, class_n=9, feat_dim=123, nfilt_inp=8,
              nfilt_inn=16, proj_dim=82)
    if family == "cnn_maxpool":
        return (FlaxCNNEncoder(**kw), CNNEncoder(**kw),
                lambda m, r: m.read_cnn_params(r), 6)
    kw["conv_filter_num"] = 4
    return (FlaxCNNStrideEncoder(**kw), CNNStrideEncoder(**kw),
            lambda m, r: m.read_cnn_params(r), 6)


@pytest.mark.parametrize("family", ["srf_naive", "srf_lowmemory", "stf",
                                    "lstm", "blstm", "cnn_maxpool",
                                    "cnn_stride"])
def test_tf_readers_match_jax(family):
    """The port's read_*_params give JAX's trees from the same reader,
    and the port's checked state_dict of them equals convert of JAX's tree
    and loads (strictly) into the port's model."""
    flax_model, model, read, enc_num, *init_args = _family_models(family)
    variables = random_flax_variables(
        flax_model, 123, init_args=init_args[0] if init_args else None)
    ref_family = family.split("_")[0]
    reader = DictReader(reference_names(
        ref_family, variables, enc_num, flavor=family[4:]))
    want = read(jax_import, reader)
    got = read(import_tf_ckpt, reader)
    assert got[2] == want[2] == enc_num
    for part in (0, 1):
        flat_got, flat_want = flatten_tree(got[part]), flatten_tree(
            {k: np.asarray(v) if not isinstance(v, dict) else v
             for k, v in want[part].items()})
        assert sorted(flat_got) == sorted(flat_want)
        for key, value in flat_want.items():
            np.testing.assert_array_equal(flat_got[key], np.asarray(value),
                                          err_msg=key)
    state = import_tf_ckpt.imported_state_dict(model, *got[:2])
    expect = convert.flax_to_state_dict(
        {"params": want[0], "batch_stats": want[1]})
    assert sorted(state) == sorted(expect)
    for key in expect:
        assert torch.equal(state[key], expect[key]), key
    model.load_state_dict(state)
    # and the model now holds the tree the reference names were made of
    drawn = flatten_tree(variables["params"])
    for key, value in flatten_tree(convert.state_dict_to_flax(
            model.state_dict())["params"]).items():
        np.testing.assert_array_equal(value, drawn[key], err_msg=key)


def test_import_refuses_a_wrong_architecture():
    flax_model, model, read, enc_num = _family_models("srf_naive")
    variables = random_flax_variables(flax_model, 123)
    names = reference_names("srf", variables, enc_num)
    names["wgt/1"] = names["wgt/1"][:, :, :-1]  # one in-capsule fewer
    params, stats, _ = import_tf_ckpt.read_srf_params(DictReader(names))
    with pytest.raises(SystemExit, match="shape mismatch at W1"):
        import_tf_ckpt.imported_state_dict(model, params, stats)
    with pytest.raises(KeyError, match="not a reference SRF"):
        import_tf_ckpt.read_srf_params(DictReader({"proj/kernel": 0}))
