"""Entry point: train and decode the Speech-Transformer (STF) CTC encoder
(port of ``srf_tpu/trainer_tf.py``).

Same flags as the JAX trainer (conf file + command line merge, plus
``--device``), one process per device (the CUDA device unless
``--device=cpu``), multi-process as ``trainer_sr`` is. It is
``trainer_sr`` with the reference's STF deltas:

- the attention penalty (reference: trainer_tf.py:144-146,285) and the
  padding-bias mask passed into self-attention (trainer_tf.py:141-142,
  train_helper.py:382-401), both computed per batch from its padded width
  (:func:`make_stf_extra_kwargs`);
- ``in_len_div`` = the front end's true subsampling
  (``models.registry.stf_in_len_div``; the reference's transposed formula
  is logged where it differs);
- a full validation pass before training starts (trainer_tf.py:336).

Train mode (``--train-max-epoch`` > 0) builds the loaders, runs that pass
and ``train/loop.run_training``; decode mode (``--train-max-epoch=0``)
decodes the test split with the masked logits (``run_decoding``). The
training extras of ``trainer_sr`` apply as in JAX's trainer_tf:
``--tpu-bf16``, ``--tpu-specaug``, ``--tpu-ema-decay`` (and
``--tpu-decode-ema`` in decode mode) and ``--tpu-grad-accum``; JAX's
trainer_tf has no MWER branch, and neither has this one.

``--tpu-pipeline-stages`` S > 1 pipelines the encoder blocks over a
``("data", "pipe")`` mesh of the world's ranks (``parallel/pipeline.py``;
rank = data index x S + stage), as JAX's trainer does: S must divide
``--model-encoder-num``, ``auto`` attention resolves to ``plain``, and
``--tpu-bf16``, ``--tpu-specaug`` and ``--tpu-fsdp`` are ignored with a
warning (not composed with the pipeline). The gradients are summed over
the whole mesh, the loss and BatchNorm over the data group.

Usage:
    python -m srf_tpu_torch.trainer_tf --config=egs/conf/timit.conf \\
        --model-type=stf --path-base=... --path-ckpt=... \\
        --train-max-epoch=N [--device=cpu]
"""

import math
import os
import sys

import torch

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.data.loader import (
    EvalLoader, LazySpeechDataset, SpeechDataset,
)
from srf_tpu_torch.models.registry import (
    stf_in_len_div, validate_dropout_kernel, validate_stf_attention_kernel,
)
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.ops.attention_penalty import create_attention_penalty
from srf_tpu_torch.ops.masking import get_padding_bias
from srf_tpu_torch.ops.specaugment import make_augment_fn
from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.parallel.mesh import (
    broadcast_state, make_mesh, make_pipeline_mesh,
)
from srf_tpu_torch.parallel.pipeline import make_pipeline_apply_fn
from srf_tpu_torch.train.loop import device_prefetch, run_decoding, run_training
from srf_tpu_torch.train.state import param_count
from srf_tpu_torch.train.step import (
    make_apply_fn, make_logits_fn, make_train_step, make_valid_step,
)
from srf_tpu_torch.trainer_sr import (
    build_loaders, build_state, decode_with_ema, get_data_len,
    refuse_unported, state_to_tree,
)
from srf_tpu_torch.utils.checkpoint import load_checkpoint, restore_into
from srf_tpu_torch.utils.metrics import MeanMetric
from srf_tpu_torch.utils.vocab import get_file_path, load_vocab


def make_stf_extra_kwargs(att_pen, in_len_div):
    """Per-batch STF keyword arguments: the [B,1,1,T'] padding bias and the
    [1,T',T'] penalty board (None without a penalty) on the features'
    device, and ``in_len_div``."""

    def extra(batch):
        feats = batch["feats"]
        out_frames = math.ceil(feats.shape[1] / in_len_div)
        inp_len = torch.as_tensor(batch["inp_len"]).to(feats.device)
        return {
            "mask": get_padding_bias(inp_len, out_frames, in_len_div),
            "attention_penalty_mask": (
                att_pen.penalty(out_frames, feats.device)
                if att_pen is not None else None),
            "in_len_div": in_len_div,
        }

    return extra


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
    logger.info(
        "The modified output Dimension %d, blank index %d", dec_out_dim,
        dec_in_dim,
    )
    pipe_stages = config.tpu_pipeline_stages or 1
    if pipe_stages > 1:
        # (data x pipe): the blocks stream over 'pipe', the batch shards
        # over 'data'
        mesh = make_pipeline_mesh(pipe_stages, config.tpu_mesh_data,
                                  device=config.device)
    else:
        mesh = make_mesh(config.tpu_mesh_data, device=config.device)
    logger.info("Mesh: %s", mesh.shape)

    logger.info("Analysing data samples..")
    train_num, valid_num, test_num = get_data_len(config)
    logger.info(
        "Data number: Train %s, Valid %s, Test %s", train_num, valid_num, test_num
    )

    att_kernel = validate_stf_attention_kernel(config)
    validate_dropout_kernel(config, "stf")
    att_pen = create_attention_penalty(config, logger)
    if att_kernel == "blockwise" and att_pen is not None:
        # the dense board is the plain path's input; blockwise recomputes
        # its values per tile from the model's penalty_params
        logger.info(
            "attention penalty: closed-form per-tile (blockwise kernel); "
            "the dense board is not materialized"
        )
        att_pen = None
    in_len_div = stf_in_len_div(config, logger)
    # the initial weights follow --tpu-seed, as JAX's PRNGKey(tpu_seed)
    model = ConvEncoder.from_config(
        config, dec_out_dim,
        generator=torch.Generator().manual_seed(config.tpu_seed))
    if pipe_stages > 1:
        if config.model_encoder_num % pipe_stages:
            raise ValueError(
                "--tpu-pipeline-stages=%d must divide "
                "--model-encoder-num=%d"
                % (pipe_stages, config.model_encoder_num))
        if config.tpu_bf16 or config.tpu_specaug or config.tpu_fsdp:
            logger.warning(
                "--tpu-bf16/--tpu-specaug/--tpu-fsdp are ignored under "
                "--tpu-pipeline-stages (not yet composed)")
    state = build_state(config, logger, model, mesh, train,
                        shard=pipe_stages == 1)
    logger.info("Model parameters: %d", param_count(state.model))
    ckpt_manager, _, epoch_offset = load_checkpoint(
        config, logger, state, params_only=not train)
    # one replicated state: rank 0's, as JAX's make_global_replicated
    broadcast_state(state)
    if pipe_stages > 1:
        # one schedule for every bucket: 'auto' cannot choose per batch
        # shape there, so it resolves to plain, as in JAX
        pipe_impl = "blockwise" if att_kernel == "blockwise" else "plain"
        if att_kernel == "auto":
            logger.info(
                "pipeline: --tpu-attention-kernel=auto resolves to "
                "'plain' under --tpu-pipeline-stages (per-bucket auto "
                "selection is not composed); pass =blockwise explicitly "
                "for long sequences")
        apply_fn = make_pipeline_apply_fn(
            state.model, mesh, config.tpu_pipeline_microbatch, att_pen,
            in_len_div, impl=pipe_impl, remat=config.tpu_pipeline_remat)
        logger.info(
            "Pipeline parallelism: %d stages x %d data shards, "
            "<=%d microbatches/step", pipe_stages, mesh.shape["data"],
            config.tpu_pipeline_microbatch)
    else:
        apply_fn = make_apply_fn(state.model,
                                 make_stf_extra_kwargs(att_pen, in_len_div),
                                 bf16=config.tpu_bf16,
                                 augment_fn=make_augment_fn(config))

    if not train:
        test_ptrn = os.path.join(config.path_base, config.path_test_ptrn)
        ds_cls = LazySpeechDataset if config.tpu_data_lazy else SpeechDataset
        test_ds = ds_cls(
            test_ptrn, config.feat_dim, config.prep_max_inp,
            config.prep_max_tar, with_utt_id=True,
        )
        decode_with_ema(config, logger, state)
        run_decoding(
            config, logger, state, make_logits_fn(apply_fn),
            EvalLoader(test_ds, batch_size=config.tpu_decode_batch,
                       pad_last=config.tpu_decode_pad_last),
            in_len_div, beam_width=config.decoding_beam_width,
        )
        ckpt_manager.close()
        return

    train_loader, valid_loader = build_loaders(config, logger, mesh,
                                               seed=config.tpu_seed)
    group = mesh.group("data")
    # the pipeline sums its gradients over every rank: each block's come
    # from its own stage, the front end's and the head's from one stage
    grad_group = (torch.distributed.group.WORLD
                  if pipe_stages > 1 and mesh.device_mesh is not None
                  else None)
    train_step = make_train_step(apply_fn, in_len_div,
                                 accum_steps=config.tpu_grad_accum,
                                 ema_decay=config.tpu_ema_decay,
                                 group=group, grad_group=grad_group)
    valid_step = make_valid_step(apply_fn, in_len_div, group)

    # pre-training validation pass (reference: trainer_tf.py:336)
    pre_valid = MeanMetric()
    for batch in device_prefetch(iter(valid_loader), state.device):
        metrics = valid_step(state, batch)
        pre_valid.update(metrics["loss_sum"], metrics["samples"])
    logger.info("Pre-training Valid Loss %.4f", pre_valid.result())

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
