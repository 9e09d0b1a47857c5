"""GPipe pipeline parallelism for the STF encoder over a ``pipe`` process
group (port of ``srf_tpu/parallel/pipeline.py``).

The N identical ``EncoderBlock``s are split into S contiguous stages, one
per rank of the ``pipe`` group; the batch is split into M microbatches
that stream through the stages. The tick schedule is JAX's, written out
by hand:

    tick t (0 .. M+S-2):  stage s runs microbatch t - s  (when valid)
    bubble = (S - 1) / (M + S - 1)

After its blocks, stage s sends the activations to stage s + 1 and
receives the next microbatch's from s - 1 in one differentiable exchange
(``parallel.distributed.ppermute``: its backward sends the gradients the
inverse way, as JAX's transposed ``ppermute``). The last stage's outputs
are broadcast over ``pipe``, so the head and the CTC loss run replicated,
as after JAX's ``psum``. ``torch.distributed.pipelining`` is not used: its
schedules own the loss on the last stage, which is not JAX's semantics.

Every rank keeps the whole replicated model, as JAX's state does (the
checkpoint tree is unchanged), and runs only its own stage's blocks. The
backward leaves the other stages' block gradients empty; the front end's
gradient exists on stage 0 only (the other stages' embeddings feed
nothing), and the head's is taken on the last stage only (the others run
it on detached parameters). So summing every gradient over the whole
(data, pipe) mesh (``train/step.make_train_step``'s ``grad_group``) gives
JAX's.

Autograd runs the backward of each rank's exchanges in reverse tick order
(the engine takes the latest-created ready node first), and every
exchange's output feeds the broadcast, so each stage's exchanges are
reached in the same order as its neighbours': the point-to-point calls
pair up. Dropout folds (data rank, stage·L_local + layer, microbatch) into
a seed per block and microbatch (F22; JAX folds the same indices into its
key); each draws from its own generator, made inside the stage, so
``--tpu-pipeline-remat`` (``torch.utils.checkpoint`` per stage and
microbatch) replays the same masks.
"""

import math

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from srf_tpu_torch.ops.dropout import site_seed
from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.train.step import divisor_at_most


def stack_block_params(state_dict, num_layers, prefix="enc%d"):
    """{name: [N, ...]} from the ``enc0`` .. ``enc{N-1}`` entries of a
    ``ConvEncoder`` state_dict (the blocks are alike)."""
    first = prefix % 0 + "."
    names = [k[len(first):] for k in state_dict if k.startswith(first)]
    return {name: torch.stack([state_dict[prefix % i + "." + name]
                               for i in range(num_layers)])
            for name in names}


def unstack_block_params(stacked, num_layers, prefix="enc%d"):
    """The inverse of :func:`stack_block_params`: {"enc<i>.<name>": ...}."""
    return {prefix % i + "." + name: value[i]
            for name, value in stacked.items() for i in range(num_layers)}


def make_stf_block_fn(model, impl="plain"):
    """``block_fn(i, x, mask, att_pen, generator) -> x`` running the
    model's block ``enc<i>`` (the sequential forward's own modules) with
    attention ``impl``; training follows the model's mode."""

    def block_fn(index, x, mask, att_pen, generator):
        return getattr(model, "enc%d" % index)(x, mask, att_pen, generator,
                                                impl)

    return block_fn


class _StageOutput(torch.autograd.Function):
    """The last stage's outputs broadcast over ``pipe``. Backward: the
    last stage keeps its own gradient (every rank's loss is the same one,
    computed replicated), and every other rank's exchanges get zeros, so
    autograd reaches them."""

    @staticmethod
    def forward(ctx, out, group, src, *anchors):
        ctx.is_src = distributed.rank(group) == src
        ctx.anchor_meta = [(a.shape, a.dtype, a.device) for a in anchors]
        buf = out.detach().clone().contiguous()
        dist.broadcast(buf, distributed.global_rank(group, src), group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        zeros = [torch.zeros(shape, dtype=dtype, device=device)
                 for shape, dtype, device in ctx.anchor_meta]
        return (grad if ctx.is_src else None, None, None, *zeros)


def pipeline_blocks(block_fn, num_blocks, x, mask, att_pen, group,
                    num_microbatches, seed=None, data_rank=0, remat=False):
    """The N blocks as an S-stage pipeline over ``group`` (S its size; this
    rank is stage ``rank(group)``).

    ``x``: [B, T, D] block inputs (the same on every stage); ``mask``:
    [B, 1, 1, T] padding bias or None; ``att_pen``: the penalty board or
    None. ``seed``: the blocks' dropout seed (None without dropout).
    Returns [B, T, D] on every stage, equal to the N blocks applied in
    turn (without dropout)."""
    stages, stage = distributed.world_size(group), distributed.rank(group)
    if num_blocks % stages:
        raise ValueError("num blocks %d not divisible by %d pipeline stages"
                         % (num_blocks, stages))
    batch, micro = x.shape[0], num_microbatches
    if batch % micro:
        raise ValueError("batch %d not divisible by %d microbatches"
                         % (batch, micro))
    per_stage = num_blocks // stages
    x_mb = x.chunk(micro, 0)
    mask_mb = mask.chunk(micro, 0) if mask is not None else [None] * micro
    if seed is not None:
        seed = site_seed(seed, data_rank)

    def run_stage(h, mb_mask, mb_index):
        for i in range(per_stage):
            layer = stage * per_stage + i
            generator = None
            if seed is not None:
                generator = torch.Generator(h.device).manual_seed(
                    site_seed(site_seed(seed, layer), mb_index))
            h = block_fn(layer, h, mb_mask, att_pen, generator)
        return h

    template = torch.zeros_like(x_mb[0])
    # what a receive-only exchange takes as its input: autograd records a
    # node only for an input that requires a gradient, and the receive's
    # backward must send its gradient back
    token = torch.zeros(0, device=x.device,
                        requires_grad=torch.is_grad_enabled())
    received = {}  # microbatch -> activations from the previous stage
    outs, anchors = [], []
    for tick in range(micro + stages - 1):
        mb_index = tick - stage
        h = None
        if 0 <= mb_index < micro:
            inp = x_mb[mb_index] if stage == 0 else received.pop(mb_index)
            if remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(
                    run_stage, inp, mask_mb[mb_index], mb_index,
                    use_reentrant=False)
            else:
                h = run_stage(inp, mask_mb[mb_index], mb_index)
            if stage == stages - 1:
                outs.append(h)
        send = h is not None and stage < stages - 1
        recv = stage > 0 and 0 <= tick + 1 - stage < micro
        if send or recv:
            got = distributed.ppermute(
                h if send else token, group,
                dst=stage + 1 if send else None,
                src=stage - 1 if recv else None, like=template)
            anchors.append(got)
            if recv:
                received[tick + 1 - stage] = got
    out = torch.cat(outs, 0) if outs else torch.zeros_like(x)
    return _StageOutput.apply(out, group, stages - 1, *anchors)


def bubble(stages, microbatches):
    """GPipe's idle share of a step: (S - 1) / (M + S - 1)."""
    return (stages - 1) / (microbatches + stages - 1)


def make_pipeline_apply_fn(model, mesh, num_microbatches, att_pen=None,
                           in_len_div=4, impl="plain", remat=False):
    """An STF forward with the block stack pipelined over ``mesh``'s
    ``pipe`` axis, shaped as ``train/step.make_apply_fn``'s adapter:
    ``apply_fn(batch, training, generator) -> float32 logits``. The front
    end (with BatchNorm over the mesh's data group) and the head run on
    every stage; the microbatch count is the largest divisor of this
    rank's batch at most ``num_microbatches``."""
    from srf_tpu_torch.ops.masking import get_padding_bias

    group = mesh.group("pipe")
    last = distributed.rank(group) == mesh.shape["pipe"] - 1
    block_fn = make_stf_block_fn(model, impl)
    head = {name: p for name, p in model.named_parameters()
            if name.startswith(("ln.", "proj."))}

    def apply_fn(batch, training, generator=None):
        model.train(training)
        feats = batch["feats"]
        lengths = batch["inp_len"].to(feats.device, non_blocking=True)
        out_frames = math.ceil(feats.shape[1] / in_len_div)
        mask = get_padding_bias(lengths, out_frames, in_len_div)
        pen = (att_pen.penalty(out_frames, feats.device)
               if att_pen is not None else None)
        emb, _ = model(feats, lengths, generator, in_len_div=in_len_div,
                       stage="embed")
        seed = None
        if training and generator is not None:
            seed = site_seed(generator.initial_seed(), 104729)
        out = pipeline_blocks(
            block_fn, model.num_layers, emb, mask, pen, group,
            divisor_at_most(feats.shape[0], num_microbatches), seed=seed,
            data_rank=mesh.index("data"), remat=remat)
        if last:
            logits = model(out, stage="head")
        else:
            # the head's gradient is the last stage's alone
            logits = torch.func.functional_call(
                model, {k: p.detach() for k, p in head.items()}, (out,),
                {"stage": "head"})
        return logits.float()

    return apply_fn
