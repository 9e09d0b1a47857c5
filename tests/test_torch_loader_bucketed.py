"""The port's bucketed training loader (``data/loader.py``) against
``srf_tpu.data.loader``: over the same TFRecords, both packages'
``BucketedLoader`` give byte-equal batches (``feats``, ``labels``,
``inp_len``, ``tar_len``, ``bucket``, ``utt_ids``) in the same order over 3
epochs, with shuffling on and off, remainders dropped or kept, with and
without the producer thread, and with an utterance whose label exceeds its
bucket's static cap (skipped by both, with a warning); ``set_epoch``
replays an epoch; ``plan_lockstep_epoch`` equals JAX's; a producer error
reaches the consumer; the multi-process modes are refused."""

import contextlib
import io
import logging

import numpy as np
import pytest

from srf_tpu.data import loader as jax_loader
from srf_tpu_torch.data import loader
from srf_tpu_torch.data.example_proto import encode_example
from srf_tpu_torch.data.tfrecord import TFRecordWriter

FEAT_DIM = 5
BOUNDARIES, BATCH_SIZES = [20, 35, 50], [5, 3, 2, 2]
KEYS = ("feats", "labels", "inp_len", "tar_len", "bucket", "utt_ids")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    base = tmp_path_factory.mktemp("bucketed")
    rng = np.random.RandomState(0)
    writers = [TFRecordWriter(str(base / ("split-%d" % s))) for s in range(3)]
    for i in range(47):
        frames = int(rng.randint(8, 64))
        labels = rng.randint(1, 40, size=max(2, frames // 6))
        if i == 11:  # longer than bucket 0's static cap (20)
            frames, labels = 15, rng.randint(1, 40, size=25)
        writers[i % 3].write(encode_example({
            "target_label": labels.astype(np.int64),
            "input_speech": rng.randn(frames, FEAT_DIM).astype(
                np.float32).flatten(),
            "input_length": np.asarray([frames], np.int64),
            "target_length": np.asarray([labels.size], np.int64),
            "utt_id": [("u%02d" % i).encode()],
        }))
    for writer in writers:
        writer.close()
    return str(base / "split-*")


@contextlib.contextmanager
def _warnings():
    """What the loader logs ("srf_tpu_torch", which the trainer's Logger
    may have set not to propagate)."""
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    logger = logging.getLogger("srf_tpu_torch")
    logger.addHandler(handler)
    try:
        yield stream
    finally:
        logger.removeHandler(handler)


def _datasets(pattern):
    return (jax_loader.SpeechDataset(pattern, FEAT_DIM, with_utt_id=True),
            loader.SpeechDataset(pattern, FEAT_DIM, with_utt_id=True))


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(KEYS)
        for key in ("feats", "labels", "inp_len", "tar_len"):
            assert g[key].dtype == w[key].dtype, key
            assert g[key].shape == w[key].shape, key
            assert g[key].tobytes() == w[key].tobytes(), key
        assert g["bucket"] == w["bucket"] and g["utt_ids"] == w["utt_ids"]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_equal_jax(shards, shuffle, drop_remainder, prefetch):
    jax_ds, ds = _datasets(shards)
    kwargs = dict(shuffle=shuffle, seed=3, drop_remainder=drop_remainder,
                  prefetch=prefetch)
    want_loader = jax_loader.BucketedLoader(jax_ds, BOUNDARIES, BATCH_SIZES,
                                            **kwargs)
    got_loader = loader.BucketedLoader(ds, BOUNDARIES, BATCH_SIZES, **kwargs)
    assert got_loader.batch_shapes() == want_loader.batch_shapes()
    assert got_loader.time_widths == want_loader.time_widths
    assert got_loader.label_caps == want_loader.label_caps
    epochs = []
    for epoch in range(3):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        with _warnings() as log:
            got = list(got_loader)
        _assert_same(got, list(want_loader))
        assert "skipped 1 example(s)" in log.getvalue()
        ids = [u for batch in got for u in batch["utt_ids"]]
        assert "u11" not in ids and len(ids) == len(set(ids))
        assert all(batch["feats"].shape[:2] == (
            BATCH_SIZES[batch["bucket"]] if drop_remainder
            else batch["feats"].shape[0],
            got_loader.time_widths[batch["bucket"]]) for batch in got)
        epochs.append(ids)
    assert (epochs[0] != epochs[1]) == shuffle
    # set_epoch replays an epoch's order
    got_loader.set_epoch(1)
    assert [u for batch in got_loader for u in batch["utt_ids"]] == epochs[1]
    if not drop_remainder:
        assert len(epochs[0]) == 46  # every utterance but the skipped one


def test_plan_lockstep_epoch_equals_jax():
    rng = np.random.RandomState(1)
    caps = [10, 18, 25, 32]
    for trial in range(20):
        peers = [(rng.randint(5, 64, size=int(rng.randint(0, 40))),
                  rng.randint(1, 30, size=64)) for _ in range(
                      int(rng.randint(1, 5)))]
        peers = [(inp, lab[:inp.size]) for inp, lab in peers]
        for shuffle in (False, True):
            args = (peers, BOUNDARIES, BATCH_SIZES, caps, 3, trial, shuffle)
            got = loader.plan_lockstep_epoch(*args)
            assert got == jax_loader.plan_lockstep_epoch(*args)
            assert len({len(schedule) for schedule in got}) == 1
            assert len({tuple(b for b, _ in schedule) for schedule in got}
                       ) == 1


class _Broken:
    """A dataset whose 7th feature read fails."""

    def __init__(self, ds):
        self.ds = ds
        self.feat_dim, self.labels, self.utt_ids = (ds.feat_dim, ds.labels,
                                                    ds.utt_ids)
        self.inp_lens, self.lab_lens = ds.inp_lens, ds.lab_lens
        self.reads = 0

    def __len__(self):
        return len(self.ds)

    @property
    def feats(self):
        return self

    def __getitem__(self, i):
        self.reads += 1
        if self.reads == 7:
            raise OSError("shard read failed")
        return self.ds.feats[i]


def test_producer_error_reaches_the_consumer(shards):
    _, ds = _datasets(shards)
    broken = loader.BucketedLoader(_Broken(ds), BOUNDARIES, BATCH_SIZES,
                                   prefetch=2)
    with pytest.raises(OSError, match="shard read failed"):
        list(broken)


def test_multi_process_modes_are_refused(shards):
    """The multi-process modes run (tests/test_torch_parallel.py holds
    them to JAX's schedules on two ranks); what JAX refuses is refused:
    both modes at once, and batch sharding of sizes the processes do not
    divide."""
    _, ds = _datasets(shards)
    with pytest.raises(ValueError, match="alternative"):
        loader.BucketedLoader(ds, BOUNDARIES, BATCH_SIZES, global_sync=True,
                              shard_batches=True)
    with pytest.raises(ValueError, match="divisible by process_count=3"):
        loader.BucketedLoader(ds, BOUNDARIES, [3, 4, 6, 6], process_count=3,
                              shard_batches=True)
    sliced = loader.BucketedLoader(ds, BOUNDARIES, [4, 4, 4, 2], prefetch=0,
                                   shard_batches=True, process_index=1,
                                   process_count=2)
    assert [s[0] for s in sliced.batch_shapes()] == [2, 2, 2, 1]
