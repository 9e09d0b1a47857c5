"""Entry point: train and decode SRF, CNN and (B)LSTM CTC models (port of
``srf_tpu/trainer_sr.py``; the STF has ``trainer_tf``).

Same flags as the JAX trainer (conf file + command line merge, plus
``--device``), one process on one device (the CUDA device unless
``--device=cpu``).

- Train mode (``--train-max-epoch`` > 0): the train and valid TFRecord
  splits go through ``BucketedLoader`` (frame-budget buckets from
  ``--train-batch-frame`` with ``--train-batch-dynamic``, else
  ``--train-batch-size``); the model's initial weights come from a
  ``torch.Generator`` seeded with ``--tpu-seed``; the state resumes from
  the checkpoint under ``--path-ckpt`` (its step is the epoch offset; the
  optimizer runs at the current flags' rate, so the recipe's stage 2 can
  resume stage 1 with another ``--train-lr-param-k``), and
  ``train/loop.run_training`` runs the epochs: per-epoch checkpoints,
  early stopping, ``metrics.jsonl``, and ``--tpu-ckpt-every-steps``
  mid-epoch checkpoints with resume. The training extras run as in JAX
  (``train/step.py``): ``--tpu-grad-accum`` microbatches, the
  ``--tpu-ema-decay`` EMA of the parameters (saved as the checkpoint's
  ``"ema"``), ``--tpu-specaug`` masking, ``--tpu-bf16`` mixed precision
  and, with ``--train-is-mwer``, MWER fine-tuning (``train/mwer.py``:
  ``--tpu-mwer-nbest``, ``--tpu-mwer-lam-ctc``, the beam
  ``--decoding-beam-width`` or max(4 x n-best, 16)).
- Decode mode (``--train-max-epoch=0``): decodes the test split from the
  checkpoint under ``--path-ckpt`` (``--path-ckpt-epoch`` N or the
  latest; the recipe passes ``$ckpt/avg``): TFRecord shards ->
  ``EvalLoader`` (``--tpu-decode-batch``, ``--tpu-decode-pad-last``) -> the
  model's eval forward on the device -> CTC beam search
  (``--tpu-decode-impl`` device|host|greedy, ``--decoding-beam-width``,
  ``--tpu-lm-path``) -> ``UTTID`` lines on stdout for
  ``srf_tpu_torch.utils.log2utt``. ``--tpu-decode-ema`` decodes with the
  checkpoint's EMA weights (and the live BatchNorm statistics);
  ``--tpu-bf16`` runs the forward in bf16.

Refused (``NotImplementedError``, naming its ROADMAP.md item 7): FSDP,
asynchronous checkpoints and more than one device or process.

Usage:
    python -m srf_tpu_torch.trainer_sr --config=egs/conf/timit.conf \\
        --path-base=... --path-ckpt=... --train-max-epoch=N [--device=cpu]
"""

import os
import sys

import torch

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.data.bucketing import get_bucket_info, round_batch_sizes
from srf_tpu_torch.data.loader import (
    BucketedLoader, EvalLoader, LazySpeechDataset, SpeechDataset,
)
from srf_tpu_torch.data.tfrecord import count_records
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops.specaugment import make_augment_fn
from srf_tpu_torch.train.loop import run_decoding, run_training
from srf_tpu_torch.train.optimizer import get_optimizer
from srf_tpu_torch.train.state import TrainState, param_count
from srf_tpu_torch.train.step import (
    make_apply_fn, make_logits_fn, make_train_step, make_valid_step,
)
from srf_tpu_torch.utils.checkpoint import load_checkpoint, restore_into
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

_LATER = "%s is not ported yet: ROADMAP.md section 1 item %d"
# (flag, is it set, the ROADMAP.md section 1 item it waits for: 7,
# parallelism)
REFUSED = (
    ("--tpu-fsdp", lambda c: c.tpu_fsdp, 7),
    ("--tpu-async-ckpt", lambda c: c.tpu_async_ckpt, 7),
    ("--tpu-mesh-data > 1", lambda c: (c.tpu_mesh_data or 1) > 1, 7),
)


def refuse_unported(config, refused=REFUSED):
    """Raise NotImplementedError, naming its ROADMAP item, for the first
    flag of ``refused`` that ``config`` sets."""
    for flag, is_set, item in refused:
        if is_set(config):
            raise NotImplementedError(_LATER % (flag, item))


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


def build_loaders(config, logger, num_replicas=1, seed=0):
    """(train_loader, valid_loader) with static bucket shapes, for one
    process (the JAX trainer's single-process branch)."""
    feat_dim = config.feat_dim
    train_ptrn = os.path.join(config.path_base, config.path_train_ptrn)
    valid_ptrn = os.path.join(config.path_base, config.path_valid_ptrn)
    ds_cls = LazySpeechDataset if config.tpu_data_lazy else SpeechDataset
    train_ds = ds_cls(train_ptrn, feat_dim, config.prep_max_inp,
                      config.prep_max_tar)
    valid_ds = ds_cls(valid_ptrn, feat_dim, config.prep_max_inp,
                      config.prep_max_tar)
    if config.train_batch_dynamic:
        if not (config.train_batch_frame and config.train_batch_frame > 0):
            raise ValueError("--train-batch-dynamic needs a positive "
                             "--train-batch-frame")
        boundaries, batch_sizes = get_bucket_info(
            config.train_batch_frame, num_replicas, 241, 10000, 150,
            step_for_bucket_size=False,
            manual_bucket_batch_sizes=config.train_batch_buckets,
        )
        batch_sizes = round_batch_sizes(batch_sizes, num_replicas)
        logger.info("bucket_boundaries: [%s]", ", ".join(map(str, boundaries)))
        logger.info("bucket_batch_sizes: [%s]", ", ".join(map(str, batch_sizes)))
    else:
        if not (config.train_batch_size and config.train_batch_size > 0):
            raise ValueError("--train-batch-size must be positive")
        boundaries = []
        batch_sizes = [max(
            num_replicas,
            config.train_batch_size // num_replicas * num_replicas,
        )]
    train_loader = BucketedLoader(
        train_ds, boundaries, batch_sizes, shuffle=True, seed=seed,
        drop_remainder=True,
    )
    valid_loader = BucketedLoader(
        valid_ds, boundaries, batch_sizes, shuffle=False,
        drop_remainder=True,
    )
    return train_loader, valid_loader


def state_to_tree(state):
    """The checkpoint dict of a TrainState (``utils/checkpoint.py``); the
    ``"ema"`` key only where the state keeps an EMA, so that a run without
    one writes the same keys as before EMA existed (JAX's
    ``state_to_tree``)."""
    tree = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": (state.scheduler.state_dict()
                      if state.scheduler is not None else None),
    }
    if state.ema is not None:
        tree["ema"] = state.ema
    return tree


def uses_ema(config):
    """Whether the state keeps an EMA of the parameters (JAX's
    ``state_template``): training with --tpu-ema-decay > 0, or decoding
    with --tpu-decode-ema."""
    return ((config.tpu_ema_decay or 0.0) > 0.0
            or bool(config.tpu_decode_ema))


def decode_with_ema(config, logger, state):
    """--tpu-decode-ema: the checkpoint's EMA into the parameters (the
    BatchNorm statistics stay the live ones), as JAX's decode mode swaps
    ``params`` for ``ema_params``; raises JAX's ValueError for a
    checkpoint without one."""
    if not config.tpu_decode_ema:
        return
    state.load_ema_weights()
    logger.info("Decoding with EMA params (--tpu-decode-ema)")


def make_mwer_step(config, logger, apply_fn, in_len_div, blank_idx):
    """The MWER train step of ``--train-is-mwer`` (JAX's trainer_sr
    branch), with its warnings."""
    from srf_tpu_torch.train.mwer import make_mwer_train_step

    if (config.tpu_ema_decay or 0.0) > 0:
        logger.warning(
            "MWER mode does not update --tpu-ema-decay EMA params "
            "(the EMA from the pre-fine-tune checkpoint is carried "
            "through unchanged)"
        )
    # an unset --decoding-beam-width must not mean "unpruned": the host
    # n-best search grows exponentially without a beam cap
    beam = config.decoding_beam_width or max(4 * config.tpu_mwer_nbest, 16)
    logger.info(
        "MWER fine-tune: beam %d, n-best %d, lambda-CTC %.3f, grad-accum %d",
        beam, config.tpu_mwer_nbest, config.tpu_mwer_lam_ctc,
        config.tpu_grad_accum,
    )
    return make_mwer_train_step(
        apply_fn, make_logits_fn(apply_fn), in_len_div, beam_width=beam,
        n_best=config.tpu_mwer_nbest, blank_id=blank_idx,
        lam_ctc=config.tpu_mwer_lam_ctc, accum_steps=config.tpu_grad_accum)


def main(argv=None):
    logger = Logger(name="srf_tpu_torch", level=Logger.DEBUG).logger
    config = ParseOption(argv or sys.argv, logger).args
    refuse_unported(config)
    train = config.train_max_epoch != 0

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

    # the initial weights follow --tpu-seed, as JAX's PRNGKey(tpu_seed)
    model, in_len_div = build_model(
        config, dec_out_dim, logger,
        generator=torch.Generator().manual_seed(config.tpu_seed))
    optimizer, scheduler = (get_optimizer(config, model.parameters())
                            if train else (None, None))
    state = TrainState.create(model, optimizer, scheduler,
                              with_ema=uses_ema(config),
                              device=config.device)
    logger.info("Model parameters: %d", param_count(state.model))
    ckpt_manager, _, epoch_offset = load_checkpoint(
        config, logger, state, params_only=not train)
    apply_fn = make_apply_fn(state.model, bf16=config.tpu_bf16,
                             augment_fn=make_augment_fn(config))

    if not train:
        # decode mode (reference: trainer_sr.py:290-299)
        test_ptrn = os.path.join(config.path_base, config.path_test_ptrn)
        ds_cls = LazySpeechDataset if config.tpu_data_lazy else SpeechDataset
        test_ds = ds_cls(
            test_ptrn, config.feat_dim, config.prep_max_inp,
            config.prep_max_tar, with_utt_id=True,
        )
        test_loader = EvalLoader(
            test_ds, batch_size=config.tpu_decode_batch,
            pad_last=config.tpu_decode_pad_last,
        )
        decode_with_ema(config, logger, state)
        run_decoding(
            config, logger, state, make_logits_fn(apply_fn), test_loader,
            in_len_div, beam_width=config.decoding_beam_width,
        )
        ckpt_manager.close()
        return

    train_loader, valid_loader = build_loaders(config, logger,
                                               seed=config.tpu_seed)
    if config.train_is_mwer:
        train_step = make_mwer_step(config, logger, apply_fn, in_len_div,
                                    blank_idx)
    else:
        train_step = make_train_step(apply_fn, in_len_div,
                                     accum_steps=config.tpu_grad_accum,
                                     ema_decay=config.tpu_ema_decay)
    valid_step = make_valid_step(apply_fn, in_len_div)
    metrics_path = (
        os.path.join(config.path_ckpt, "metrics.jsonl") if config.path_ckpt else None
    )
    run_training(
        config, logger, state, train_step, valid_step, train_loader,
        valid_loader, ckpt_manager, epoch_offset, config.tpu_seed,
        train_num or 1,
        schedule_fn=scheduler.lr_lambdas[0] if scheduler is not None else None,
        metrics_path=metrics_path, state_to_save=state_to_tree,
        state_from_tree=lambda tree: restore_into(state, tree),
    )
    ckpt_manager.close()


if __name__ == "__main__":
    main()
