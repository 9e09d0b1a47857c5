"""Host input pipeline: TFRecord shards -> padded batches (the port's own
copy of ``srf_tpu/data/loader.py``, numpy only).

- examples are parsed off TFRecord shards with the clean-room codec,
- length filters match ``_filter_max_length``
  (reference: load_speech_data.py:48-50),
- training batches are bucketed with the reference's frame-budget geometry
  (``data/bucketing.py``) and padded to their **bucket boundary**, so each
  bucket is one static shape (few shapes for cuDNN's search to time); label
  padding is likewise static per bucket; train batches drop remainders
  (reference: load_speech_data.py:174 drop_remainder=True),
- eval batches keep every utterance with its utt id, time padded to a
  multiple of 128 frames (reference: data_helper.py:50-66),
- a background producer thread overlaps host parsing with device compute.

Batches stay numpy, the JAX loader's arrays exactly: the consumer moves
``feats`` and ``labels`` to the device and keeps the lengths on the host
(``train/loop.device_prefetch``, ``train/step.py``).

Multi-process (one process per card, ``parallel/distributed.py``), as
JAX's loader:

- example sharding (``--tpu-data-shard=example``): each process's dataset
  keeps every ``process_count``-th example (round-robin by
  ``process_index``), and ``global_sync`` lockstep-schedules the epoch:
  every process's (input, label) lengths are all-gathered once over the
  host group, and each epoch every process runs the same
  :func:`plan_lockstep_epoch` and emits its own sub-batch of each
  scheduled global batch (identical shapes and step counts everywhere);
- batch sharding (``--tpu-data-shard=batch``, ``shard_batches``): every
  process reads the whole split and takes its contiguous 1/n slice of
  each global batch (the reference's AutoShardPolicy.DATA).
"""

import glob as _glob
import logging
import os as _os
import queue
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
                 with_utt_id=False, process_index=0, process_count=1):
        self.feat_dim = feat_dim
        self.with_utt_id = with_utt_id
        paths = sorted(_glob.glob(file_pattern))
        if not paths:
            raise FileNotFoundError("no TFRecord shards match %s" % file_pattern)
        feats, labels, utt_ids = [], [], []
        idx = -1
        for path in paths:
            for record in read_records(path):
                idx += 1
                if idx % process_count != process_index:
                    continue  # another process's example
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
                 with_utt_id=False, process_index=0, process_count=1):
        self.feat_dim = feat_dim
        self.with_utt_id = with_utt_id
        paths = sorted(_glob.glob(file_pattern))
        if not paths:
            raise FileNotFoundError("no TFRecord shards match %s" % file_pattern)
        spans, labels, utt_ids, inp_lens = [], [], [], []
        idx = -1
        for path_idx, path in enumerate(paths):
            for offset, length, record in iter_record_spans(path):
                idx += 1
                if idx % process_count != process_index:
                    continue  # another process's example
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


def plan_lockstep_epoch(peer_lens, boundaries, batch_sizes, label_caps,
                        seed, epoch, shuffle):
    """Globally agreed bucket-batch schedule for multi-process training.

    ``peer_lens[p] = (inp_lens, lab_lens)`` holds EVERY process's example
    lengths, so each process can run the same deterministic simulation of
    every process's shuffle + bucket pooling. A global batch of bucket
    ``b`` is scheduled for each ready local sub-batch of ``b`` up to the
    **minimum ready count across processes** (a process that never fills
    bucket ``b`` starves it globally — the lockstep analog of
    drop_remainder). The emission order is canonicalized to process 0's
    ready order, so all processes emit identical static shapes in an
    identical sequence (reference: tfsr/trainer_sr.py:147-149).

    Returns ``emissions[p] = [(bucket, local_index_tuple), ...]`` — the
    same length and bucket sequence for every process (``BucketedLoader``
    with ``global_sync``).
    """
    n_buckets = len(batch_sizes)

    def bucket_of(length):
        for b, boundary in enumerate(boundaries):
            if length <= boundary:
                return b
        return len(boundaries)

    ready = []  # per process: ([bucket -> list of index tuples], seq)
    for inp_lens, lab_lens in peer_lens:
        order = np.arange(inp_lens.size)
        if shuffle:
            np.random.RandomState(seed + epoch).shuffle(order)
        pools = [[] for _ in range(n_buckets)]
        out = [[] for _ in range(n_buckets)]
        seq = []
        for idx in order:
            b = bucket_of(int(inp_lens[idx]))
            if int(lab_lens[idx]) > label_caps[b]:
                continue  # mirrors the single-process static-cap skip
            pools[b].append(int(idx))
            if len(pools[b]) == batch_sizes[b]:
                out[b].append(tuple(pools[b]))
                seq.append(b)
                pools[b] = []
        ready.append((out, seq))
    counts = [
        min(len(r[0][b]) for r in ready) for b in range(n_buckets)
    ]
    taken = [0] * n_buckets
    schedule = []
    for b in ready[0][1]:
        if taken[b] < counts[b]:
            schedule.append((b, taken[b]))
            taken[b] += 1
    return [
        [(b, ready[p][0][b][j]) for b, j in schedule]
        for p in range(len(peer_lens))
    ]


class BucketedLoader:
    """Length-bucketed batches with one static shape per bucket.

    Each batch is the JAX loader's dict of numpy arrays (``feats`` [B, T,
    F] float32, ``labels`` [B, L], ``inp_len``, ``tar_len`` [B] int32) plus
    ``bucket`` and, when the dataset has them, ``utt_ids``. With
    ``prefetch > 0`` a producer thread builds the epoch's batches ahead
    (at most ``prefetch`` waiting); an error there reaches the consumer.

    ``global_sync`` and ``shard_batches`` with ``process_count`` > 1: the
    module docstring. ``global_sync`` all-gathers the lengths over the
    host group of the running process group
    (``parallel.distributed.host_all_gather``); this process's entry is
    its world rank's, so ranks that share a data shard (the STF
    pipeline's stages) gather the same lengths twice, which changes no
    schedule.
    """

    def __init__(self, dataset, bucket_boundaries, bucket_batch_sizes,
                 shuffle=False, seed=0, drop_remainder=True,
                 label_cap_divisor=2, prefetch=2, global_sync=False,
                 shard_batches=False, process_index=0, process_count=1):
        assert len(bucket_batch_sizes) == len(bucket_boundaries) + 1
        if shard_batches and global_sync:
            raise ValueError(
                "shard_batches and global_sync are alternative multi-process"
                " modes: batch sharding needs the FULL (unsharded) dataset on"
                " every process; global_sync lockstep-schedules per-process"
                " example shards")
        self._shard_batches = bool(shard_batches) and process_count > 1
        self._shard = (int(process_index), int(process_count))
        if self._shard_batches:
            # every process sees the same metadata, so the (seed,
            # epoch)-keyed schedule is the same everywhere with no
            # collective: the one-process schedule, sliced
            bad = [bs for bs in bucket_batch_sizes if bs % process_count]
            if bad:
                raise ValueError(
                    "batch sharding needs bucket batch sizes divisible by"
                    " process_count=%d, got %s"
                    % (process_count, list(bucket_batch_sizes)))
        self.ds = dataset
        self.boundaries = list(bucket_boundaries)
        self.batch_sizes = list(bucket_batch_sizes)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self._epoch = 0
        # Static time width per bucket = its boundary; overflow bucket uses
        # the data max. Static label width = time width / label_cap_divisor.
        # Lengths come from the dataset's length arrays (lazy datasets never
        # materialize features for bookkeeping).
        inp_lens = getattr(dataset, "inp_lens", None)
        if inp_lens is None:  # ad-hoc dataset objects (tests)
            inp_lens = [f.shape[0] for f in dataset.feats]
        lab_lens = getattr(dataset, "lab_lens", None)
        if lab_lens is None:
            lab_lens = [l.shape[0] for l in dataset.labels]
        self._inp_lens = np.asarray(inp_lens, np.int64)
        self._lab_lens = np.asarray(lab_lens, np.int64)
        max_len = int(self._inp_lens.max()) if self._inp_lens.size else 1
        max_lab = int(self._lab_lens.max()) if self._lab_lens.size else 1
        self._peer_lens = None
        self._peer_index = 0
        if global_sync and process_count > 1:
            # every process must emit the SAME static shapes in the SAME
            # order and the SAME number of batches an epoch, or one rank
            # runs an extra step and the collectives deadlock: gather
            # every process's lengths once, then plan every epoch from
            # all of them (plan_lockstep_epoch); the overflow width and
            # label cap take the global maxima
            from srf_tpu_torch.parallel import distributed

            self._peer_index = distributed.rank()
            self._peer_lens = distributed.host_all_gather(
                (self._inp_lens, self._lab_lens))
            max_len = max((int(inp.max()) for inp, _ in self._peer_lens
                           if inp.size), default=1)
            max_lab = max((int(lab.max()) for _, lab in self._peer_lens
                           if lab.size), default=1)
        self.time_widths = self.boundaries + [max(max_len, (self.boundaries[-1] if self.boundaries else 1))]
        self.label_caps = [max(8, -(-w // label_cap_divisor)) for w in self.time_widths]
        # guard: label never exceeds its cap
        self.label_caps = [max(c, min(max_lab, w)) for c, w in zip(self.label_caps, self.time_widths)]

    @property
    def per_process_schedule(self):
        """Whether the epoch's batch sequence depends on the process count:
        example sharding's lockstep schedule does (it is stratified by
        process); batch sharding slices the one-process schedule of the
        same global batches, so a batch index names the same data position
        under any process count."""
        return self._peer_lens is not None

    def set_epoch(self, epoch):
        """Pin the shuffle order to ``epoch``'s (seed+epoch keys the
        permutation). The train loop calls this each epoch, which makes the
        order a pure function of (seed, epoch) — so a restarted process
        (per-epoch resume or mid-epoch preemption resume) replays exactly
        the order the uninterrupted run would have seen."""
        self._epoch = int(epoch)

    def _bucket_of(self, length):
        for b, boundary in enumerate(self.boundaries):
            if length <= boundary:
                return b
        return len(self.boundaries)

    def batch_shapes(self):
        """All static (batch, time, label) shapes this loader can emit (the
        process's slice under batch sharding)."""
        div = self._shard[1] if self._shard_batches else 1
        return [
            (bs // div, tw, lc)
            for bs, tw, lc in zip(self.batch_sizes, self.time_widths, self.label_caps)
        ]

    def _emit_shard(self, indices, bucket):
        """The whole batch, or under batch sharding this process's
        contiguous 1/n slice of it. A remainder batch slices to len // n
        each (the same on every process: the pools are the same
        everywhere) and is skipped where that is 0, so the step counts
        stay in lockstep."""
        if not self._shard_batches:
            return self._emit(indices, bucket)
        p, n = self._shard
        k = len(indices) // n
        dropped = len(indices) - k * n
        if dropped:
            logging.getLogger("srf_tpu_torch").warning(
                "BucketedLoader: batch sharding dropped %d remainder "
                "example(s) of a %d-example bucket batch (not divisible "
                "by process_count=%d)", dropped, len(indices), n,
            )
        if k == 0:
            return None
        return self._emit(indices[p * k:(p + 1) * k], bucket)

    def _iter_epoch(self):
        if self._peer_lens is not None:
            yield from self._iter_epoch_lockstep()
            return
        ds = self.ds
        order = np.arange(len(ds))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        pools = [[] for _ in self.batch_sizes]
        skipped = 0
        for idx in order:
            b = self._bucket_of(int(self._inp_lens[idx]))
            if int(self._lab_lens[idx]) > self.label_caps[b]:
                skipped += 1  # pathological: label longer than static cap
                continue
            pools[b].append(idx)
            if len(pools[b]) == self.batch_sizes[b]:
                batch = self._emit_shard(pools[b], b)
                if batch is not None:
                    yield batch
                pools[b] = []
        if skipped:
            # operator-visible: the reference pipeline pads to the batch
            # max and would keep these, so a shrinking corpus must not be
            # silent
            logging.getLogger("srf_tpu_torch").warning(
                "BucketedLoader: skipped %d example(s) whose label length "
                "exceeds the bucket's static cap this epoch", skipped,
            )
        if not self.drop_remainder:
            for b, pool in enumerate(pools):
                if pool:
                    batch = self._emit_shard(pool, b)
                    if batch is not None:
                        yield batch

    def _iter_epoch_lockstep(self):
        """A multi-process epoch: the global schedule from every process's
        lengths, this process's sub-batch of each scheduled step. No
        remainder batches (one process's remainder would desync the step
        counts)."""
        epoch = self._epoch
        self._epoch += 1
        emissions = plan_lockstep_epoch(
            self._peer_lens, self.boundaries, self.batch_sizes,
            self.label_caps, self.seed, epoch, self.shuffle,
        )[self._peer_index]
        skipped = int(sum(
            lab > self.label_caps[self._bucket_of(int(inp))]
            for inp, lab in zip(self._inp_lens, self._lab_lens)))
        if skipped:
            logging.getLogger("srf_tpu_torch").warning(
                "BucketedLoader: skipped %d example(s) whose label length "
                "exceeds the bucket's static cap this epoch", skipped,
            )
        for b, idxs in emissions:
            yield self._emit(list(idxs), b)

    def _emit(self, indices, bucket):
        ds = self.ds
        batch = _pad_batch(
            [ds.feats[i] for i in indices],
            [ds.labels[i] for i in indices],
            self.time_widths[bucket],
            self.label_caps[bucket],
            ds.feat_dim,
        )
        batch["bucket"] = bucket
        if ds.utt_ids is not None:
            batch["utt_ids"] = [ds.utt_ids[i] for i in indices]
        return batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._iter_epoch()
            return
        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure = []

        def producer():
            # a producer-thread error must REACH the consumer: putting the
            # sentinel alone would look like a clean end-of-epoch and the
            # trainer would silently continue on a truncated epoch
            try:
                for item in self._iter_epoch():
                    q.put(item)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                failure.append(exc)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
        if failure:
            raise failure[0]


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
