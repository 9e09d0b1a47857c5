"""Host input pipeline for decoding: TFRecord shards -> padded eval batches
(the port's own copy of the dataset and eval parts of
``srf_tpu/data/loader.py``, numpy only).

- examples are parsed off TFRecord shards with the clean-room codec,
- length filters match ``_filter_max_length``
  (reference: load_speech_data.py:48-50),
- eval batches keep every utterance with its utt id, time padded to a
  multiple of 128 frames (reference: data_helper.py:50-66).

Batches stay numpy: the consumer moves ``feats`` to the device and keeps
the lengths on the host (``train/step.py``). The bucketed training loader
is not ported yet.
"""

import glob as _glob
import os as _os
import threading

import numpy as np

from srf_tpu_torch.data.example_proto import decode_example
from srf_tpu_torch.data.tfrecord import (
    iter_record_spans, read_record_at, read_records,
)


class SpeechDataset:
    """Parsed, in-memory view of one split (these corpora fit host RAM;
    ``LazySpeechDataset`` is the out-of-core drop-in for ones that don't)."""

    def __init__(self, file_pattern, feat_dim, max_inp=-1, max_tar=-1,
                 with_utt_id=False):
        self.feat_dim = feat_dim
        self.with_utt_id = with_utt_id
        paths = sorted(_glob.glob(file_pattern))
        if not paths:
            raise FileNotFoundError("no TFRecord shards match %s" % file_pattern)
        feats, labels, utt_ids = [], [], []
        for path in paths:
            for record in read_records(path):
                ex = decode_example(record)
                inp_len = int(ex["input_length"][0])
                tar_len = int(ex["target_length"][0])
                if max_inp >= 1 and inp_len > max_inp:
                    continue
                if max_tar >= 1 and tar_len > max_tar:
                    continue
                feats.append(
                    np.asarray(ex["input_speech"], np.float32).reshape(inp_len, feat_dim)
                )
                labels.append(np.asarray(ex["target_label"], np.int32))
                if with_utt_id:
                    utt_ids.append(ex["utt_id"][0].decode("utf-8"))
        self.feats = feats
        self.labels = labels
        self.utt_ids = utt_ids if with_utt_id else None
        self.inp_lens = np.asarray([f.shape[0] for f in feats], np.int64)
        self.lab_lens = np.asarray([l.shape[0] for l in labels], np.int64)

    def __len__(self):
        return len(self.feats)


class _LazyFeats:
    """Indexable feature view reading record payloads on demand.

    One fd per shard, positional reads (``os.pread``) — safe to share
    between threads without locks, and no per-access ``open``."""

    def __init__(self, paths, spans, feat_dim, inp_lens):
        self._paths = paths
        self._spans = spans  # [(path_idx, offset, length), ...]
        self._feat_dim = feat_dim
        self._inp_lens = inp_lens
        self._fds = [None] * len(paths)
        # the reads themselves (os.pread) are positional and lock-free;
        # only the lazy first-open per shard needs the lock, or two
        # threads racing it would each open the file and leak one fd
        self._open_lock = threading.Lock()

    def _fd(self, path_idx):
        fd = self._fds[path_idx]
        if fd is None:
            with self._open_lock:
                fd = self._fds[path_idx]
                if fd is None:
                    fd = _os.open(self._paths[path_idx], _os.O_RDONLY)
                    self._fds[path_idx] = fd
        return fd

    def __len__(self):
        return len(self._spans)

    def __getitem__(self, i):
        path_idx, offset, length = self._spans[i]
        ex = decode_example(read_record_at(self._fd(path_idx), offset, length))
        return np.asarray(ex["input_speech"], np.float32).reshape(
            int(self._inp_lens[i]), self._feat_dim
        )

    def __iter__(self):
        for i in range(len(self._spans)):
            yield self[i]

    def __del__(self):
        for fd in self._fds:
            if fd is not None:
                try:
                    _os.close(fd)
                except OSError:
                    pass


class LazySpeechDataset:
    """Out-of-core drop-in for ``SpeechDataset``: one sequential index
    scan at construction records each kept example's (shard, offset,
    length) span plus its lengths/labels/utt id (all small); feature
    matrices are read back per batch from the shard files.

    Resident cost is O(index + labels) instead of O(all features) —
    ~1 MB per 10k utterances vs ~13 GB for a WSJ-sized split — at the
    price of one positional read + proto parse per example per pass. The
    counterpart of the reference's streaming tf.data reader
    (reference: tfsr/data/load_speech_data.py:43-46, 100 MB read
    buffers); enable with ``--tpu-data-lazy=True``."""

    def __init__(self, file_pattern, feat_dim, max_inp=-1, max_tar=-1,
                 with_utt_id=False):
        self.feat_dim = feat_dim
        self.with_utt_id = with_utt_id
        paths = sorted(_glob.glob(file_pattern))
        if not paths:
            raise FileNotFoundError("no TFRecord shards match %s" % file_pattern)
        spans, labels, utt_ids, inp_lens = [], [], [], []
        for path_idx, path in enumerate(paths):
            for offset, length, record in iter_record_spans(path):
                ex = decode_example(record)
                inp_len = int(ex["input_length"][0])
                tar_len = int(ex["target_length"][0])
                if max_inp >= 1 and inp_len > max_inp:
                    continue
                if max_tar >= 1 and tar_len > max_tar:
                    continue
                spans.append((path_idx, offset, length))
                inp_lens.append(inp_len)
                labels.append(np.asarray(ex["target_label"], np.int32))
                if with_utt_id:
                    utt_ids.append(ex["utt_id"][0].decode("utf-8"))
        self.labels = labels
        self.utt_ids = utt_ids if with_utt_id else None
        self.inp_lens = np.asarray(inp_lens, np.int64)
        self.lab_lens = np.asarray([l.shape[0] for l in labels], np.int64)
        self.feats = _LazyFeats(paths, spans, feat_dim, self.inp_lens)

    def __len__(self):
        return len(self.feats)


def _pad_batch(feat_list, label_list, time_width, label_width, feat_dim):
    batch = len(feat_list)
    feats = np.zeros((batch, time_width, feat_dim), np.float32)
    labels = np.zeros((batch, label_width), np.int32)
    inp_len = np.zeros((batch,), np.int32)
    tar_len = np.zeros((batch,), np.int32)
    for i, (f, l) in enumerate(zip(feat_list, label_list)):
        feats[i, : f.shape[0]] = f
        labels[i, : l.shape[0]] = l
        inp_len[i] = f.shape[0]
        tar_len[i] = l.shape[0]
    return {"feats": feats, "labels": labels, "inp_len": inp_len, "tar_len": tar_len}


class EvalLoader:
    """Eval batches with utt ids, padded per-batch (default batch 1 = the
    reference decode protocol; ``--tpu-decode-batch`` raises it).

    Pads time to the next multiple of ``pad_multiple`` to bound the number of
    compiled shapes during decoding (the reference pads to the exact length). When the utterance count
    is not divisible by the batch size, the default falls back to batch 1 —
    the reference hard-codes the same fallback (load_speech_data.py:127-145),
    which silently costs the whole batching win on e.g. WSJ's 333-utterance
    test set. ``pad_last=True`` (``--tpu-decode-pad-last``) keeps the batch
    size and pads the final batch with 1-frame dummy utterances instead:
    ``utt_ids`` lists only the real utterances (real rows come first), so
    consumers that enumerate utt ids skip the dummy hypotheses naturally;
    ``batch["valid"]`` carries the real count for other consumers.
    """

    def __init__(self, dataset, batch_size=1, pad_multiple=128,
                 pad_last=False):
        self.ds = dataset
        self.batch_size = max(1, batch_size)
        self.pad_multiple = pad_multiple
        self.pad_last = pad_last
        if (self.batch_size != 1 and not pad_last
                and len(dataset) % self.batch_size != 0):
            self.batch_size = 1

    def __iter__(self):
        ds = self.ds
        for start in range(0, len(ds), self.batch_size):
            idxs = range(start, min(start + self.batch_size, len(ds)))
            feat_list = [ds.feats[i] for i in idxs]
            label_list = [ds.labels[i] for i in idxs]
            n_real = len(feat_list)
            n_pad = 0
            if self.pad_last and n_real < self.batch_size:
                n_pad = self.batch_size - n_real
                feat_list = feat_list + [
                    np.zeros((1, ds.feat_dim), np.float32)
                ] * n_pad
                label_list = label_list + [np.zeros((1,), np.int32)] * n_pad
            max_len = max(f.shape[0] for f in feat_list)
            width = -(-max_len // self.pad_multiple) * self.pad_multiple
            max_lab = max(max(l.shape[0] for l in label_list), 1)
            batch = _pad_batch(feat_list, label_list, width, max_lab, ds.feat_dim)
            batch["valid"] = n_real
            if ds.utt_ids is not None:
                batch["utt_ids"] = [ds.utt_ids[i] for i in idxs]
            yield batch
