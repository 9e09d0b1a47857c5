"""Dataset serialization: npy features + JSON manifests -> TFRecord shards
(the port's own copy of ``srf_tpu/data/writer.py``, numpy only; the shards
are byte-equal to the JAX writer's).

Behavioral port of the reference writer
(reference: tfsr/data/save_speech_data.py:39-266):

- JSON-lines manifest with {"key", "duration", "text"} per utterance
  (reference: egs/data/sample.json),
- per-speaker CMVN as ``(feats - mean + 1e-14) / (std + 1e-14)``
  (reference: save_speech_data.py:162-163),
- corpus-specific speaker/utterance id parsing for wsj/libri/timit
  (reference: save_speech_data.py:143-160),
- round-robin sharding across ``prep_data_shard`` files for train, one shard
  for valid/test, ``.incomplete`` temp names renamed on completion, skip when
  all shards already exist (reference: save_speech_data.py:79-121,197-205),
- shard names ``name-split-feattype-dim-%.5d-of-%.5d``
  (reference: save_speech_data.py:105-107),
- post-hoc in-memory shuffle of each train shard
  (reference: save_speech_data.py:212-229).
"""

import glob
import json
import os
import random
import sys
import time

import numpy as np

from srf_tpu_torch.config.constants import ExitCode, Tag
from srf_tpu_torch.data.example_proto import encode_example
from srf_tpu_torch.data.tfrecord import TFRecordWriter, read_records
from srf_tpu_torch.utils.vocab import get_file_path, get_int_seq, load_vocab


def load_cmvn(cmvn_paths, dataset="wsj"):
    """Load per-speaker mean/std rows (reference: misc_helper.py:192-205)."""
    cmvn = {}
    for cmvn_file in glob.glob(cmvn_paths):
        if dataset == "wsj":
            cmvn[cmvn_file.split("spk_")[1][:3]] = np.loadtxt(cmvn_file)
        elif dataset == "timit":
            cmvn[cmvn_file.split("spk_")[1][:5]] = np.loadtxt(cmvn_file)
        elif dataset == "libri":
            cmvn[cmvn_file.split("spk_")[1].split(".")[0]] = np.loadtxt(cmvn_file)
    return cmvn, len(cmvn)


def parse_utt_ids(key, data_name, decoding_from_npy):
    """Speaker/utterance id extraction per corpus."""
    spk_id = None
    if data_name == "wsj":
        modified_key = key.replace("//", "/")
        utt_split_idx = 4 if modified_key.find("wsj64k") == -1 else 5
        if not decoding_from_npy:
            spk_id = modified_key.split("/")[utt_split_idx]
        utt_id = key.split("/")[-1].split(".")[0]
    elif data_name == "libri":
        if not decoding_from_npy:
            parts = key.split("/")[-1].split("-")
            spk_id = parts[0] + "-" + parts[1]
        utt_id = key.split("/")[-1].split(".")[0]
    elif data_name == "timit":
        if decoding_from_npy:
            _id = key.split("/")[-1].split(".npy")[0].split("_")
            utt_id = _id[0] + "-" + _id[1]
        else:
            spk_id = key.split("/DR")[1].split("/")[1]
            utt_id = spk_id + "-" + key.split("/")[-1].split(".")[0]
    else:
        utt_id = key.split("/")[-1].split(".")[0]
    return spk_id, utt_id


def convert_to_tfrecord(logger, config, data_set, cmvn):
    """Write one split's shards; returns (paths, n_examples_written)."""
    data_path = config.path_base
    feat_type = config.feat_type
    feat_dim = config.feat_dim
    data_name = config.prep_data_name
    if config.path_wrt_tfrecord is None:
        logger.critical("path-wrt-tfrecord is None")
        sys.exit(1)
    tfrecord_dir = config.path_wrt_tfrecord
    is_char = config.prep_data_unit == "char"

    if data_set == Tag.TRAIN:
        meta_file = get_file_path(data_path, config.path_train_json)
        total_shards = config.prep_data_shard
    elif data_set == Tag.VALID:
        meta_file = get_file_path(data_path, config.path_valid_json)
        total_shards = 1
    elif data_set == Tag.TEST:
        meta_file = get_file_path(data_path, config.path_test_json)
        total_shards = 1
    else:
        logger.critical(
            "type of data set must be one of %s, %s, %s but %s was provided.",
            Tag.TRAIN, Tag.VALID, Tag.TEST, data_set,
        )
        sys.exit(ExitCode.INVALID_OPTION.value)

    vocab_path = get_file_path(data_path, config.path_vocab)
    if not os.path.isfile(vocab_path):
        logger.critical("%s does not exist.", vocab_path)
        sys.exit(ExitCode.INVALID_FILE_PATH.value)
    _, vocab, _, _ = load_vocab(vocab_path, logger)

    out_dir = get_file_path(data_path, tfrecord_dir)
    os.makedirs(out_dir, exist_ok=True)
    tfrecord_paths = [
        os.path.join(
            out_dir,
            "%s-%s-%s-%d-%.5d-of-%.5d"
            % (data_name, data_set, feat_type, feat_dim, shard + 1, total_shards),
        )
        for shard in range(total_shards)
    ]

    counter = 0
    if all(os.path.exists(p) for p in tfrecord_paths):
        logger.info("TFRecords of %s already exist." % tfrecord_paths)
        return tfrecord_paths, counter

    logger.info("TFRecords of %s are being saved into %s", meta_file, tfrecord_paths)
    start = time.time()
    tmp_paths = [p + ".incomplete" for p in tfrecord_paths]
    writers = [TFRecordWriter(p) for p in tmp_paths]

    shard = 0
    with open(meta_file) as json_file:
        for json_line in json_file:
            spec = json.loads(json_line.strip())
            if config.decoding_from_npy:
                feats = np.load(get_file_path(data_path, spec["key"]))
            else:
                feats = np.load(
                    get_file_path(
                        data_path, spec["key"] + "." + str(config.feat_type) + ".npy"
                    )
                )

            spk_id, utt_id = parse_utt_ids(
                spec["key"], data_name, config.decoding_from_npy
            )
            if cmvn:
                feats = (feats - cmvn[spk_id][0] + 1e-14) / (cmvn[spk_id][1] + 1e-14)

            if feats.shape[1] != config.feat_dim:
                logger.critical(
                    "feature dimension option is incorrect! generated: %d, given: %d",
                    feats.shape[1], config.feat_dim,
                )
                sys.exit(ExitCode.INVALID_OPTION.value)

            int_seq = get_int_seq(spec["text"], is_char=is_char, vocab=vocab)
            serialized = encode_example(
                {
                    "target_label": np.asarray(int_seq, np.int64),
                    "input_speech": np.asarray(feats, np.float32).flatten(),
                    "input_length": np.asarray([feats.shape[0]], np.int64),
                    "target_length": np.asarray([len(int_seq)], np.int64),
                    "utt_id": [utt_id.encode("utf-8")],
                }
            )
            writers[shard].write(serialized)
            shard = (shard + 1) % total_shards
            counter += 1

    for writer in writers:
        writer.close()
    for tmp_name, final_name in zip(tmp_paths, tfrecord_paths):
        os.replace(tmp_name, final_name)

    logger.info("Saved %d Examples in %.2f seconds", counter, time.time() - start)
    return tfrecord_paths, counter


def shuffle_records(tfrecord_file, seed=None):
    """Shuffle records within a single shard file.

    Atomic: the shuffled records are written to a temp name and
    os.replace'd over the shard in one step. The previous in-place
    rewrite could be interrupted mid-write, leaving a TRUNCATED shard
    that the all-shards-exist skip check (convert_to_tfrecord) would
    then accept as complete — silently losing training data."""
    records = list(read_records(tfrecord_file))
    rng = random.Random(seed)
    rng.shuffle(records)
    tmp_fname = tfrecord_file + ".shuffling"
    with TFRecordWriter(tmp_fname) as writer:
        for record in records:
            writer.write(record)
    os.replace(tmp_fname, tfrecord_file)
