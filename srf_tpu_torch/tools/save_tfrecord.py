"""CLI: convert npy features + JSON manifests to TFRecord shards (the
port's copy of ``srf_tpu/tools/save_tfrecord.py``: stage 0 of the recipes).

Reference parity: tfsr/data/save_speech_data.py main() (:232-266) — loads
per-speaker CMVN unless ``--decoding-from-npy``, converts train/valid/test
splits, then shuffles the train shards.

Usage:
    python -m srf_tpu_torch.tools.save_tfrecord --path-base=... \
        --path-train-json=... --path-wrt-tfrecord=... ...
"""

import sys

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.config.constants import Tag
from srf_tpu_torch.data.writer import (
    convert_to_tfrecord, load_cmvn, shuffle_records,
)
from srf_tpu_torch.utils.vocab import get_file_path


def main(argv=None):
    logger = Logger(name="TFRecord", level=Logger.DEBUG).logger
    config = ParseOption(argv or sys.argv, logger).args

    if config.decoding_from_npy:
        cmvn = None
    else:
        cmvn_path = get_file_path(config.path_base, config.path_cmvn_ptrn)
        cmvn, spk_n = load_cmvn(cmvn_paths=cmvn_path,
                                dataset=config.prep_data_name)
        logger.info(
            "Feature mean and variance for %d speakers from %s", spk_n, cmvn_path
        )

    tfrecord_files = None
    if config.path_train_json is not None:
        tfrecord_files, examples = convert_to_tfrecord(
            logger, config, Tag.TRAIN, cmvn
        )
    if config.path_valid_json is not None:
        convert_to_tfrecord(logger, config, Tag.VALID, cmvn)
    if config.path_test_json is not None:
        convert_to_tfrecord(logger, config, Tag.TEST, cmvn)

    if tfrecord_files:
        logger.info("Shuffling training data.")
        for tfrecord_file in tfrecord_files:
            shuffle_records(tfrecord_file)


if __name__ == "__main__":
    main()
