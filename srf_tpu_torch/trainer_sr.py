"""Entry point: train and decode SRF, CNN and (B)LSTM CTC models (port of
``srf_tpu/trainer_sr.py``; the STF has ``trainer_tf``).

Same flags as the JAX trainer (conf file + command line merge, plus
``--device``), one process per device (the CUDA device unless
``--device=cpu``). With ``SRF_COORDINATOR`` / ``SRF_NUM_PROCESSES`` /
``SRF_PROCESS_ID`` (or torchrun's variables and ``SRF_MULTIHOST=1``) it
runs as one rank of a ``torch.distributed`` world
(``parallel/distributed.py``: NCCL on CUDA, gloo on the CPU) over a
``("data", "model")`` mesh of ``--tpu-mesh-data`` ranks
(``parallel/mesh.py``), as JAX's trainer runs on a mesh:

- ``--tpu-data-shard=example`` (each rank keeps every n-th example and the
  epochs are lockstep-scheduled) or ``batch`` (each rank takes its slice
  of every global batch); bucket sizes are rounded to the rank count;
- the state is broadcast from rank 0 after it is built or restored; the
  step is data-parallel (``train/step.py``: loss over the global batch,
  summed gradients, BatchNorm over the global batch);
- ``--tpu-fsdp`` shards the parameters and Adam's moments over the data
  axis (``parallel/sharding_rules.py``; MWER ignores it, as JAX does);
- ``--tpu-async-ckpt`` writes checkpoints on a background thread
  (``utils/checkpoint.py``).

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

``--tpu-mesh-data`` other than the number of processes raises
``ValueError`` (one process per card).

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
from srf_tpu_torch.models.layers import set_batch_norm_group
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.ops.specaugment import make_augment_fn
from srf_tpu_torch.parallel import distributed, sharding_rules
from srf_tpu_torch.parallel.mesh import broadcast_state, make_mesh
from srf_tpu_torch.train.loop import run_decoding, run_training
from srf_tpu_torch.train.optimizer import get_optimizer
from srf_tpu_torch.train.state import TrainState, param_count
from srf_tpu_torch.train.step import (
    make_apply_fn, make_logits_fn, make_train_step, make_valid_step,
)
from srf_tpu_torch.utils.checkpoint import load_checkpoint, restore_into
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab

_LATER = "%s is not ported yet: ROADMAP.md section 1 item %d"
# (flag, is it set, the ROADMAP.md section 1 item it waits for); every
# flag of this trainer is ported
REFUSED = ()


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


def build_loaders(config, logger, mesh=None, seed=0):
    """(train_loader, valid_loader) with static bucket shapes, for this
    rank's shard of the mesh's ``data`` axis (JAX's ``build_loaders``, one
    process per data shard: example sharding with a lockstep schedule, or
    ``--tpu-data-shard=batch`` slices of every global batch)."""
    n_proc = mesh.shape["data"] if mesh is not None else 1
    index = mesh.index("data") if mesh is not None else 0
    num_replicas = n_proc
    feat_dim = config.feat_dim
    train_ptrn = os.path.join(config.path_base, config.path_train_ptrn)
    valid_ptrn = os.path.join(config.path_base, config.path_valid_ptrn)
    ds_cls = LazySpeechDataset if config.tpu_data_lazy else SpeechDataset
    shard_batches = n_proc > 1 and config.tpu_data_shard == "batch"
    # batch sharding: every process scans the whole split and slices each
    # global batch; example sharding: round-robin ownership and lockstep
    # schedules
    ds_proc = (0, 1) if shard_batches else (index, n_proc)
    train_ds = ds_cls(train_ptrn, feat_dim, config.prep_max_inp,
                      config.prep_max_tar, process_index=ds_proc[0],
                      process_count=ds_proc[1])
    valid_ds = ds_cls(valid_ptrn, feat_dim, config.prep_max_inp,
                      config.prep_max_tar, process_index=ds_proc[0],
                      process_count=ds_proc[1])
    if shard_batches and not config.tpu_data_lazy:
        logger.info(
            "batch sharding loads the FULL split on every process; use "
            "--tpu-data-lazy=True to keep resident memory O(index)")
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
        if n_proc > 1:
            # each process yields its 1/n share of every global bucket
            # batch
            if any(bs % n_proc for bs in batch_sizes):
                raise ValueError(
                    "bucket batch sizes %s must divide across %d processes"
                    " - every process must contribute the same number of"
                    " devices to the data axis" % (batch_sizes, n_proc))
            if not shard_batches:
                batch_sizes = [bs // n_proc for bs in batch_sizes]
            logger.info(
                "multi-process buckets: local sizes [%s] x %d processes "
                "(%s)",
                ", ".join(str(bs // (n_proc if shard_batches else 1))
                          for bs in batch_sizes),
                n_proc,
                "global-batch slices" if shard_batches
                else "globally scheduled lockstep",
            )
    else:
        if not (config.train_batch_size and config.train_batch_size > 0):
            raise ValueError("--train-batch-size must be positive")
        # the global batch, rounded to the replica count; each process
        # yields its 1/n share
        global_batch = max(
            num_replicas,
            config.train_batch_size // num_replicas * num_replicas,
        )
        boundaries = []
        batch_sizes = [global_batch if shard_batches
                       else global_batch // n_proc]
        if n_proc > 1:
            logger.info(
                "multi-process batches: global %d = %d/process x %d "
                "processes (shapes + per-epoch step count synchronized)",
                global_batch, global_batch // n_proc, n_proc,
            )
    loader_kw = dict(global_sync=n_proc > 1 and not shard_batches,
                     shard_batches=shard_batches, process_index=index,
                     process_count=n_proc)
    train_loader = BucketedLoader(
        train_ds, boundaries, batch_sizes, shuffle=True, seed=seed,
        drop_remainder=True, **loader_kw,
    )
    valid_loader = BucketedLoader(
        valid_ds, boundaries, batch_sizes, shuffle=False,
        drop_remainder=True, **loader_kw,
    )
    return train_loader, valid_loader


def build_state(config, logger, model, mesh, train, shard=True):
    """The TrainState of this rank: the model on its device with its
    BatchNorm over the mesh's data group, its class capsules sharded over
    a ``model`` axis (``sharding_rules.apply_rules``; a mesh built through
    the library API, as no flag makes one), sharded with ``--tpu-fsdp``
    where ``shard`` (both before the optimizer, so Adam's moments shard
    with their parameters), the optimizer and schedule in train mode."""
    set_batch_norm_group(model, mesh.group("data"))
    state = TrainState.create(model, None, None, with_ema=uses_ema(config),
                              device=config.device)
    if mesh.shape.get("model", 1) > 1:
        specs = sharding_rules.apply_rules(state.model, mesh)
        logger.info("model axis: %s sharded over 'model' (%d ranks)",
                    sorted(k for k, v in specs.items() if v is not None),
                    mesh.shape["model"])
        if state.ema is not None:
            state.reset_ema()
    if train and shard and config.tpu_fsdp:
        sharding_rules.fsdp(state.model, mesh, logger, bf16=config.tpu_bf16)
        if state.ema is not None:
            state.reset_ema()
    if train:
        state.optimizer, state.scheduler = get_optimizer(
            config, state.model.parameters())
    return state


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
    # FSDP's and the 'model' axis's shards gathered (a collective), so the
    # file is one process's
    return sharding_rules.full_state(tree, state.model)


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


def make_mwer_step(config, logger, apply_fn, in_len_div, blank_idx,
                   group=None):
    """The MWER train step of ``--train-is-mwer`` (JAX's trainer_sr
    branch), with its notes and warnings."""
    from srf_tpu_torch.train.mwer import make_mwer_train_step

    if distributed.world_size() > 1:
        logger.info(
            "MWER multi-process: each rank n-best-decodes only its own "
            "rows; the update is data-parallel (train/mwer.py)")
    if config.tpu_fsdp:
        logger.warning("MWER mode ignores --tpu-fsdp sharding (plain "
                       "data-parallel step)")

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
        lam_ctc=config.tpu_mwer_lam_ctc, accum_steps=config.tpu_grad_accum,
        group=group)


def main(argv=None):
    logger = Logger(name="srf_tpu_torch", level=Logger.DEBUG).logger
    config = ParseOption(argv or sys.argv, logger).args
    refuse_unported(config)
    distributed.maybe_initialize(logger, device=config.device)
    train = config.train_max_epoch != 0

    _, _, dec_in_dim, _ = load_vocab(
        get_file_path(config.path_base, config.path_vocab), logger
    )
    dec_out_dim = dec_in_dim + 1
    blank_idx = dec_in_dim
    logger.info(
        "The modified output Dimension %d, blank index %d", dec_out_dim, blank_idx
    )

    mesh = make_mesh(config.tpu_mesh_data, device=config.device)
    group = mesh.group("data")
    logger.info("Mesh: %s (%d-way data parallel)", mesh.shape,
                mesh.shape["data"])

    logger.info("Analysing data samples..")
    train_num, valid_num, test_num = get_data_len(config)
    logger.info(
        "Data number: Train %s, Valid %s, Test %s", train_num, valid_num, test_num
    )

    # the initial weights follow --tpu-seed, as JAX's PRNGKey(tpu_seed)
    model, in_len_div = build_model(
        config, dec_out_dim, logger,
        generator=torch.Generator().manual_seed(config.tpu_seed))
    state = build_state(config, logger, model, mesh, train,
                        shard=not config.train_is_mwer)
    logger.info("Model parameters: %d", param_count(state.model))
    ckpt_manager, _, epoch_offset = load_checkpoint(
        config, logger, state, params_only=not train)
    # one replicated state: rank 0's, as JAX's make_global_replicated
    broadcast_state(state)
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

    train_loader, valid_loader = build_loaders(config, logger, mesh,
                                               seed=config.tpu_seed)
    if config.train_is_mwer:
        train_step = make_mwer_step(config, logger, apply_fn, in_len_div,
                                    blank_idx, group)
    else:
        train_step = make_train_step(apply_fn, in_len_div,
                                     accum_steps=config.tpu_grad_accum,
                                     ema_decay=config.tpu_ema_decay,
                                     group=group,
                                     model_group=mesh.group("model"))
    valid_step = make_valid_step(apply_fn, in_len_div, group,
                                 mesh.group("model"))
    metrics_path = (
        os.path.join(config.path_ckpt, "metrics.jsonl") if config.path_ckpt else None
    )
    run_training(
        config, logger, state, train_step, valid_step, train_loader,
        valid_loader, ckpt_manager, epoch_offset, config.tpu_seed,
        train_num or 1,
        schedule_fn=(state.scheduler.lr_lambdas[0]
                     if state.scheduler is not None else None),
        metrics_path=metrics_path, state_to_save=state_to_tree,
        state_from_tree=lambda tree: restore_into(state, tree),
    )
    ckpt_manager.close()


if __name__ == "__main__":
    main()
