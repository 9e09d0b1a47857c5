"""Entry point: decode SRF and CNN CTC models (port of ``srf_tpu/trainer_sr.py``,
decode mode).

Same flags as the JAX trainer (conf file + command line merge, plus
``--device``). With ``--train-max-epoch=0`` it decodes the test split from
the checkpoint under ``--path-ckpt`` (``--path-ckpt-epoch`` N or the
latest; the recipe passes ``$ckpt/avg``): TFRecord shards ->
``EvalLoader`` (``--tpu-decode-batch``, ``--tpu-decode-pad-last``) -> the
model's eval forward on the device -> CTC beam search
(``--tpu-decode-impl`` device|host|greedy, ``--decoding-beam-width``,
``--tpu-lm-path``) -> ``UTTID`` lines on stdout for
``srf_tpu_torch.utils.log2utt``. Training mode is the next slice of the
port and is refused.

Usage:
    python -m srf_tpu_torch.trainer_sr --config=egs/conf/timit.conf \\
        --path-base=... --path-ckpt=.../avg --train-max-epoch=0 [--device=cpu]
"""

import os
import sys

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.data.loader import EvalLoader, LazySpeechDataset, SpeechDataset
from srf_tpu_torch.data.tfrecord import count_records
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.train.loop import run_decoding
from srf_tpu_torch.train.state import TrainState, param_count
from srf_tpu_torch.train.step import make_apply_fn, make_logits_fn
from srf_tpu_torch.utils.checkpoint import load_checkpoint
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

_LATER = "%s is not ported yet: the next slice of the PyTorch port (training)"


def get_data_len(config):
    """Record counts per split (reference: data_helper.py:30-48)."""
    nums = []
    for num, ptrn in [
        (config.prep_data_num_train, config.path_train_ptrn),
        (config.prep_data_num_valid, config.path_valid_ptrn),
        (config.prep_data_num_test, config.path_test_ptrn),
    ]:
        if num is None and ptrn:
            num = count_records(os.path.join(config.path_base, ptrn))
        nums.append(num)
    return tuple(nums)


def main(argv=None):
    logger = Logger(name="srf_tpu_torch", level=Logger.DEBUG).logger
    config = ParseOption(argv or sys.argv, logger).args
    if config.train_max_epoch != 0:
        raise NotImplementedError(_LATER % "training (--train-max-epoch > 0)")
    if config.train_is_mwer:
        raise NotImplementedError(_LATER % "--train-is-mwer")
    if config.tpu_decode_ema:
        raise NotImplementedError(
            "--tpu-decode-ema is not ported yet: EMA is a later slice of "
            "the PyTorch port")

    _, _, dec_in_dim, _ = load_vocab(
        get_file_path(config.path_base, config.path_vocab), logger
    )
    dec_out_dim = dec_in_dim + 1
    blank_idx = dec_in_dim
    logger.info(
        "The modified output Dimension %d, blank index %d", dec_out_dim, blank_idx
    )

    logger.info("Analysing data samples..")
    train_num, valid_num, test_num = get_data_len(config)
    logger.info(
        "Data number: Train %s, Valid %s, Test %s", train_num, valid_num, test_num
    )

    model, in_len_div = build_model(config, dec_out_dim, logger)
    state = TrainState.create(model, None, device=config.device)
    logger.info("Model parameters: %d", param_count(state.model))
    ckpt_manager, _, _ = load_checkpoint(config, logger, state,
                                         params_only=True)
    apply_fn = make_apply_fn(state.model, bf16=config.tpu_bf16)

    # decode mode (reference: trainer_sr.py:290-299)
    test_ptrn = os.path.join(config.path_base, config.path_test_ptrn)
    ds_cls = LazySpeechDataset if config.tpu_data_lazy else SpeechDataset
    test_ds = ds_cls(
        test_ptrn, config.feat_dim, config.prep_max_inp, config.prep_max_tar,
        with_utt_id=True,
    )
    test_loader = EvalLoader(
        test_ds, batch_size=config.tpu_decode_batch,
        pad_last=config.tpu_decode_pad_last,
    )
    run_decoding(
        config, logger, state, make_logits_fn(apply_fn), test_loader,
        in_len_div, beam_width=config.decoding_beam_width,
    )
    ckpt_manager.close()


if __name__ == "__main__":
    main()
