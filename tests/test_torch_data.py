"""The port's TFRecord writer/readers and EvalLoader against ``srf_tpu.data``
on the same numpy-seeded examples: files byte-equal, each package reads
the other's files, and EvalLoader's batches equal at batch 1 and 3, with
and without ``pad_last``, from in-memory and lazy datasets."""

import numpy as np
import pytest

from srf_tpu.data import example_proto as jax_proto
from srf_tpu.data import loader as jax_loader
from srf_tpu.data import tfrecord as jax_tfrecord
from srf_tpu_torch.data import example_proto, loader, tfrecord

FEAT_DIM = 5
# one beyond the max_inp filter (280), widths 128/256/384 after padding
LENGTHS = (150, 3, 290, 61, 128, 129, 200, 97)
N_UTTS = len(LENGTHS)


def _examples(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(LENGTHS):
        labels = rng.randint(1, 62, size=rng.randint(1, 20)).astype(np.int64)
        out.append({
            "input_speech": rng.randn(n, FEAT_DIM).astype(np.float32),
            "target_label": labels,
            "input_length": np.array([n], np.int64),
            "target_length": np.array([labels.size], np.int64),
            "utt_id": [("utt%02d" % i).encode()],
        })
    return out


def _write(package_tfrecord, package_proto, path, examples):
    with package_tfrecord.TFRecordWriter(str(path)) as writer:
        for ex in examples:
            writer.write(package_proto.encode_example(ex))


@pytest.fixture()
def shards(tmp_path):
    """Two shards of the port's files and two of JAX's, same examples."""
    examples = _examples()
    paths = {"port": [], "jax": []}
    for shard in range(2):
        part = examples[shard::2]
        for name, (tfr, proto) in (("port", (tfrecord, example_proto)),
                                   ("jax", (jax_tfrecord, jax_proto))):
            path = tmp_path / ("%s-%d-of-2" % (name, shard))
            _write(tfr, proto, path, part)
            paths[name].append(path)
    return tmp_path, paths


def test_written_files_are_byte_equal(shards):
    _, paths = shards
    for port_path, jax_path in zip(paths["port"], paths["jax"]):
        assert port_path.read_bytes() == jax_path.read_bytes()
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


def test_each_package_reads_the_others_files(shards):
    _, paths = shards
    for reader, writer in (("port", "jax"), ("jax", "port")):
        tfr, proto = ((tfrecord, example_proto) if reader == "port"
                      else (jax_tfrecord, jax_proto))
        for path in paths[writer]:
            got = [proto.decode_example(r)
                   for r in tfr.read_records(str(path), verify_crc=True)]
            want = [jax_proto.decode_example(r)
                    for r in jax_tfrecord.read_records(str(path))]
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for key in a:
                    assert np.array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))
        assert (tfr.count_records([str(p) for p in paths[writer]])
                == N_UTTS)
    spans = list(tfrecord.iter_record_spans(str(paths["port"][0])))
    assert spans == list(jax_tfrecord.iter_record_spans(
        str(paths["port"][0])))


def test_a_truncated_file_is_refused(tmp_path, shards):
    _, paths = shards
    data = paths["port"][0].read_bytes()
    bad = tmp_path / "bad"
    bad.write_bytes(data[:-3])
    with pytest.raises(ValueError, match="truncated"):
        list(tfrecord.read_records(str(bad), verify_crc=True))
    with pytest.raises(ValueError, match="truncated"):
        tfrecord.count_records([str(bad)])


@pytest.mark.parametrize("lazy", [False, True], ids=["memory", "lazy"])
@pytest.mark.parametrize("batch_size,pad_last",
                         [(1, False), (3, False), (3, True)])
def test_eval_loader_batches_equal_jax(shards, lazy, batch_size, pad_last):
    base, _ = shards
    pattern = str(base / "port-*-of-2")
    port_cls = loader.LazySpeechDataset if lazy else loader.SpeechDataset
    jax_cls = (jax_loader.LazySpeechDataset if lazy
               else jax_loader.SpeechDataset)
    port_ds = port_cls(pattern, FEAT_DIM, max_inp=280, with_utt_id=True)
    jax_ds = jax_cls(pattern, FEAT_DIM, max_inp=280, with_utt_id=True)
    assert len(port_ds) == len(jax_ds) < N_UTTS  # max_inp drops one
    got = list(loader.EvalLoader(port_ds, batch_size, pad_last=pad_last))
    want = list(jax_loader.EvalLoader(jax_ds, batch_size, pad_last=pad_last))
    assert len(got) == len(want)
    if batch_size == 3 and not pad_last:
        assert len(got) == len(port_ds)  # indivisible: batch 1 fallback
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert a["feats"].shape[1] % 128 == 0
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]
