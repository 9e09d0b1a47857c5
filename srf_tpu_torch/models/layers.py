"""Model building blocks (port of ``srf_tpu/models/layers.py``).

:class:`Linear`, :class:`Conv2d`, :class:`LayerNorm` — torch's layers with
flax's dtype rules, which ``--tpu-bf16`` meets (bf16 parameters on bf16 or
float32 activations); with one dtype throughout they are torch's own.

:func:`same_pad` / :func:`conv2d_same` — flax's ``padding="SAME"`` with a
per-axis kernel and stride (the CNN's (5, 3) convs stride (t, 1));
``conv2d_same`` chooses cuDNN's algorithm as ``ops/conv_choice.py`` says.

:class:`ConvFrontEnd` — the reference's "CapsulationLayer" CNN front-end:
per layer two parallel stride-2 3x3 convs combined by maxout, each with
dropout 0.2, then length-mask -> BatchNorm -> length-mask
(reference: tfsr/model/sequence_router.py:44-82). BatchNorm follows flax's
``BatchNorm(momentum=0.99, epsilon=1e-3)``: in eval mode it normalises with
its running statistics; in training mode with the batch mean and the
*biased* batch variance over (B, T', F'), the zero-masked padded frames
included, and it moves the running statistics by
``ra = 0.99 * ra + 0.01 * stat`` with that same biased variance
(``nn.BatchNorm2d``'s own update would use the unbiased one). Under data
parallelism (:func:`set_batch_norm_group`) the statistics are those of the
global batch, as JAX's jitted step sees it: the sums are all-reduced over
the group, so every rank normalises by the same mean and variance, the
backward all-reduces its two sums so that their gradients reach every
rank's rows, and the running statistics stay identical on every rank.

:class:`Dropout` — inverted dropout whose masks may come from an explicit
``torch.Generator`` (the train step seeds one per step).

:class:`MultiHeadAttention` — QKV Linear (no bias), scaled dot-product with
additive ``mask * -1e9`` and the Speech-Transformer distance penalty
``+= -log(1 + penalty)``, dropout on the weights (reference:
tfsr/model/attention.py:34-174); :class:`PointWiseFeedForward` (reference:
tfsr/model/feed_forward.py:26-40); :class:`EncoderBlock`, the pre-LN
transformer block (reference: tfsr/model/block.py:32-72). In training mode
each ``Dropout`` draws from the generator passed to ``forward``.
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from srf_tpu_torch.ops import conv_choice
from srf_tpu_torch.ops.masking import feat_mask
from srf_tpu_torch.parallel.distributed import world_size


def _pair(value):
    return tuple(value) if isinstance(value, (tuple, list)) else (value, value)


def _promote(x, *params):
    """``x`` and the parameters (None stays None) in their promoted dtype:
    a flax layer computes in the dtype that promotes its input's and its
    parameters' (a bf16 weight on a float32 input computes in float32,
    where torch would refuse the mix)."""
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return [None if t is None else t.to(dtype) for t in (x, *params)]


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s dtypes (``--tpu-bf16`` runs the
    forward on bf16 parameters): input and parameters promoted to one
    dtype, and in bf16 the product rounded before the bias is added, as
    flax adds it (``F.linear`` would add it before rounding)."""

    def forward(self, x):
        x, weight, bias = _promote(x, self.weight, self.bias)
        if bias is not None and x.dtype == torch.bfloat16:
            return F.linear(x, weight) + bias
        return F.linear(x, weight, bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``Conv``'s dtypes, as :class:`Linear`."""

    def forward(self, x):
        x, weight, bias = _promote(x, self.weight, self.bias)
        if bias is not None and x.dtype == torch.bfloat16:
            return self._conv_forward(x, weight, None) + bias[:, None, None]
        return self._conv_forward(x, weight, bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``LayerNorm``'s dtypes: a float32 input
    (the STF's after its float32 positional encoding, the LSTM's cell
    output) normalises with its bf16 scale and bias in float32."""

    def forward(self, x):
        x, weight, bias = _promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, weight, bias, self.eps)


def same_pads(length, kernel_size, stride):
    """(before, after) that flax/TF ``padding="SAME"`` adds to an axis.

    SAME pads ``max((ceil(L/s)-1)*s + k - L, 0)`` in all, the odd one at
    the end: with k=3, s=2 that is (0, 1) on an even axis and (1, 1) on an
    odd one, where torch's ``padding=1`` would always pad (1, 1) and sample
    a shifted grid; with k=5, s=2 it is (1, 2) on an even axis and (2, 2)
    on an odd one.
    """
    total = max((math.ceil(length / stride) - 1) * stride + kernel_size
                - length, 0)
    return total // 2, total - total // 2


def same_pad(x, kernel_size, stride):
    """Pad the last two axes of NCHW ``x`` as flax/TF ``padding="SAME"``
    does; ``kernel_size`` and ``stride`` are an int or an (H, W) pair."""
    (k_h, k_w), (s_h, s_w) = _pair(kernel_size), _pair(stride)
    # F.pad lists the last axis first
    return F.pad(x, [*same_pads(x.shape[3], k_w, s_w),
                     *same_pads(x.shape[2], k_h, s_h)])


def conv2d_same(x, weight, stride):
    """``F.conv2d`` of NCHW ``x`` (any memory layout) with flax's SAME
    padding and no bias: the symmetric part goes to the convolution's own
    padding and only the odd one, where there is one, to an ``F.pad`` copy
    (stride 1, the CNN-TIMIT recipe's, never needs it). The algorithm is
    chosen by ``ops.conv_choice.ChosenConv2d``."""
    stride = _pair(stride)
    (t_lo, t_hi), (f_lo, f_hi) = (
        same_pads(x.shape[axis], weight.shape[axis], stride[axis - 2])
        for axis in (2, 3))
    if (t_lo, f_lo) != (t_hi, f_hi):
        x = F.pad(x, [0, f_hi - f_lo, 0, t_hi - t_lo])
    return conv_choice.ChosenConv2d.apply(x, weight, stride, (t_lo, f_lo))


class Dropout(nn.Dropout):
    """``nn.Dropout`` that draws its mask from ``generator`` (the global RNG
    when it is None): an element is kept with probability 1 - p and scaled
    by 1 / (1 - p), as flax's ``Dropout`` does (not its bits)."""

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) >= self.p
        return x * keep / (1.0 - self.p)


def set_batch_norm_group(model, group):
    """Every BatchNorm of ``model`` normalises over the global batch of
    ``group`` in training mode (None: this process's batch)."""
    for module in model.modules():
        if isinstance(module, nn.BatchNorm2d):
            module.process_group = group


def _group(bn):
    """The BatchNorm's data-parallel group, None for one process (a group
    of one rank computes this process's statistics)."""
    group = getattr(bn, "process_group", None)
    return group if group is not None and world_size(group) > 1 else None


def _update_running(bn, mean, var):
    with torch.no_grad():
        bn.running_mean.mul_(0.99).add_(mean, alpha=0.01)
        bn.running_var.mul_(0.99).add_(var, alpha=0.01)
        bn.num_batches_tracked.add_(1)


def _global_stats(x, group, fast_variance):
    """Mean, biased variance and count over (B, T', F') of the global
    batch, from sums all-reduced over ``group``: two-pass in float32, or
    E[x^2] - E[x]^2 clamped at 0 where ``fast_variance`` (flax's bf16
    formula)."""
    dims, channels = (0, 2, 3), x.shape[1]
    count = x.new_full((1,), float(x.numel() // channels))
    if fast_variance:
        sums = torch.cat([x.sum(dims), (x * x).sum(dims), count])
        dist.all_reduce(sums, group=group)
        mean = sums[:channels] / sums[-1]
        second = sums[channels:-1] / sums[-1]
        return mean, torch.clamp(second - mean * mean, min=0.0), sums[-1]
    sums = torch.cat([x.sum(dims), count])
    dist.all_reduce(sums, group=group)
    mean = sums[:-1] / sums[-1]
    centred = x - mean.reshape(1, -1, 1, 1)
    squares = (centred * centred).sum(dims)
    dist.all_reduce(squares, group=group)
    return mean, squares / sums[-1], sums[-1]


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch of ``group``:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` with the global
    statistics, and the backward of the native kernel, ``dx = (dy -
    mean(dy) - x_hat * mean(dy * x_hat)) * rsqrt(var + eps) * weight`` with
    those two means all-reduced (one collective; a composition of
    differentiable all-reduces would take two and cancel less exactly in
    the conv weights' gradients). The weight's and bias's gradients stay
    this rank's, as every parameter's do until the step sums them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, fast_variance):
        mean, var, count = _global_stats(x, group, fast_variance)
        shape = (1, -1, 1, 1)
        invstd = torch.rsqrt(var + eps)
        x_hat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        ctx.save_for_backward(x_hat, invstd * weight)
        ctx.group, ctx.count = group, count
        out = ((x - mean.reshape(shape)) * (invstd * weight).reshape(shape)
               + bias.reshape(shape))
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x_hat, scale = ctx.saved_tensors
        dims, shape = (0, 2, 3), (1, -1, 1, 1)
        local = torch.stack([grad.sum(dims), (grad * x_hat).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        means = sums / ctx.count
        grad_x = (grad - means[0].reshape(shape)
                  - x_hat * means[1].reshape(shape)) * scale.reshape(shape)
        return grad_x, local[1], local[0], None, None, None


def batch_norm(x, bn):
    """flax BatchNorm on NCHW ``x`` with ``bn``'s affine parameters and
    running statistics (the module docstring gives the conventions). A
    bf16 ``x`` (``--tpu-bf16``) takes :func:`_batch_norm_bf16`."""
    if x.dtype == torch.bfloat16:
        return _batch_norm_bf16(x, bn)
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    group = _group(bn)
    if group is not None:
        out, mean, var = _GlobalBatchNorm.apply(x, bn.weight, bn.bias,
                                                bn.eps, group, False)
        _update_running(bn, mean, var)
        return out
    with torch.no_grad():
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    _update_running(bn, mean, var)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _batch_norm_bf16(x, bn):
    """flax's BatchNorm on a bf16 ``x``, in its order of operations: the
    statistics in float32 (the variance as E[x^2] - E[x]^2, clamped at 0),
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, rounded
    to bf16 once; the running statistics stay float32."""
    xf = x.float()
    if bn.training:
        group = _group(bn)
        if group is not None:
            out, mean, var = _GlobalBatchNorm.apply(
                xf, bn.weight.float(), bn.bias.float(), bn.eps, group, True)
            _update_running(bn, mean, var)
            return out.to(x.dtype)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
        _update_running(bn, mean.detach(), var.detach())
    else:
        mean, var = bn.running_mean, bn.running_var
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean.reshape(shape)) * mul.reshape(shape)
    return (y + bn.bias.float().reshape(shape)).to(x.dtype)


class ConvFrontEnd(nn.Module):
    """Maxout conv subsampler; [B, T, F] -> [B, ceil(T/s^n), F', nfilt]."""

    def __init__(self, cnn_n, nfilt, kernel_size=3, stride=2):
        super().__init__()
        self.cnn_n = cnn_n
        self.kernel_size = kernel_size
        self.stride = stride
        in_ch = 1
        for conv_idx in range(cnn_n):
            for branch in range(2):
                setattr(self, "conv%d_%d" % (conv_idx, branch),
                        Conv2d(in_ch, nfilt, kernel_size, stride))
            setattr(self, "bn%d" % conv_idx, nn.BatchNorm2d(nfilt, eps=1e-3))
            in_ch = nfilt
        self.dropout = Dropout(0.2)

    def forward(self, inputs, input_lengths, generator=None):
        x = inputs[:, None]  # NCHW [B, 1, T, F]
        for conv_idx in range(self.cnn_n):
            x = same_pad(x, self.kernel_size, self.stride)
            x = torch.maximum(
                self.dropout(getattr(self, "conv%d_0" % conv_idx)(x),
                             generator),
                self.dropout(getattr(self, "conv%d_1" % conv_idx)(x),
                             generator),
            )
            divisor = self.stride ** (conv_idx + 1)
            x = feat_mask(x, input_lengths, divisor, time_dim=2)
            x = batch_norm(x, getattr(self, "bn%d" % conv_idx))
            x = feat_mask(x, input_lengths, divisor, time_dim=2)
        return x.permute(0, 2, 3, 1)  # the JAX layout [B, T', F', C]


def scaled_dot_product_attention(query, key, value, mask, att_pen_mask,
                                 dropout=None, generator=None):
    """Attention(Q,K,V) with the distance penalty ``+ log1p(pen) * -1`` and
    the additive ``mask * -1e9``; ``dropout`` (a ``Dropout``) acts on the
    weights. Returns (output, weights)."""
    scaled = torch.matmul(query, key.transpose(-1, -2)) / math.sqrt(
        query.shape[-1])
    if att_pen_mask is not None:
        scaled = scaled + torch.log1p(att_pen_mask) * -1.0
    if mask is not None:
        scaled = scaled + mask * -1e9
    weights = torch.softmax(scaled, dim=-1)
    if dropout is not None:
        weights = dropout(weights, generator)
    return torch.matmul(weights, value), weights


class MultiHeadAttention(nn.Module):
    """Q/K/V Linear without bias, attention, ``wo`` with a bias.

    ``impl`` (per call): ``"plain"`` materializes the
    [B, H, T, T] weights and returns them; ``"blockwise"`` runs the online
    softmax over key blocks (``ops/blockwise_attention.py``) with the
    closed-form penalty ``penalty_params`` and returns weights None;
    ``"ring"`` splits the time axis over the ranks of ``group``
    (``ops/ring_attention.py``; no dropout) and returns weights None.
    ``site`` keys the blockwise path's dropout seeds apart from other
    attention layers'.
    """

    def __init__(self, d_model, num_heads, attention_dropout=0.0,
                 penalty_params=None, site=0, group=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model %d (--model-dimension) is not a multiple "
                             "of the %d heads (--model-att-head-num)"
                             % (d_model, num_heads))
        self.d_model = d_model
        self.num_heads = num_heads
        self.penalty_params = penalty_params
        self.site = site
        self.group = group
        for name in ("wq", "wk", "wv"):
            setattr(self, name, Linear(d_model, d_model, bias=False))
        self.wo = Linear(d_model, d_model)
        self.att_dropout = Dropout(attention_dropout)

    def _split(self, x):
        batch = x.shape[0]
        return x.reshape(batch, -1, self.num_heads,
                         self.d_model // self.num_heads).transpose(1, 2)

    def forward(self, value, key, query, mask, att_pen_mask, generator=None,
                impl="plain"):
        q = self._split(self.wq(query))
        k = self._split(self.wk(key))
        v = self._split(self.wv(value))
        if impl == "plain":
            attended, weights = scaled_dot_product_attention(
                q, k, v, mask, att_pen_mask, self.att_dropout, generator)
        elif impl == "blockwise":
            from srf_tpu_torch.ops.blockwise_attention import (
                blockwise_attention,
            )
            from srf_tpu_torch.ops.dropout import site_seed

            rate = self.att_dropout.p if self.training else 0.0
            seed = None
            if rate > 0.0:
                base = (generator.initial_seed() if generator is not None
                        else int(torch.randint(1 << 62, ()).item()))
                seed = site_seed(base, self.site)
            attended = blockwise_attention(
                q, k, v, mask, penalty=self.penalty_params,
                dropout_rate=rate, dropout_seed=seed)
            weights = None
        elif impl == "ring":
            from srf_tpu_torch.ops.ring_attention import ring_attention

            if self.training and self.att_dropout.p > 0:
                raise ValueError(
                    "ring attention does not support attention dropout; "
                    "train with --tpu-attention-kernel=blockwise or set "
                    "attention dropout to 0")
            if self.group is None:
                raise ValueError(
                    "attention_impl='ring' requires group= (the process "
                    "group whose ranks split the time dimension)")
            attended = ring_attention(q, k, v, self.group, mask,
                                      self.penalty_params)
            weights = None
        else:
            raise ValueError("unknown attention impl %r" % impl)
        attended = attended.transpose(1, 2).reshape(
            query.shape[0], -1, self.d_model)
        return self.wo(attended), weights


class PointWiseFeedForward(nn.Module):
    def __init__(self, d_model, dff, ff_dropout):
        super().__init__()
        self.ff1 = Linear(d_model, dff)
        self.ff2 = Linear(dff, d_model)
        self.dropout = Dropout(ff_dropout)

    def forward(self, inputs, generator=None):
        return self.ff2(self.dropout(torch.relu(self.ff1(inputs)), generator))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (reference: tfsr/model/block.py:32-72):
    ``ln_cur`` -> MHA -> residual dropout -> add, then ``ln_res`` -> FFN ->
    residual dropout -> add; LayerNorm eps 1e-6."""

    def __init__(self, d_model, num_heads, dff, inner_dropout,
                 residual_dropout, attention_dropout, penalty_params=None,
                 site=0, group=None):
        super().__init__()
        self.ln_cur = LayerNorm(d_model, eps=1e-6)
        self.mha = MultiHeadAttention(d_model, num_heads, attention_dropout,
                                      penalty_params, site, group)
        self.ln_res = LayerNorm(d_model, eps=1e-6)
        self.ffn = PointWiseFeedForward(d_model, dff, inner_dropout)
        self.res_dropout = Dropout(residual_dropout)

    def forward(self, inputs, mask, att_pen_mask, generator=None,
                impl="plain"):
        emb = self.ln_cur(inputs)
        attn_out, _ = self.mha(emb, emb, emb, mask, att_pen_mask, generator,
                               impl)
        out1 = inputs + self.res_dropout(attn_out, generator)
        ffn_out = self.ffn(self.ln_res(out1), generator)
        return out1 + self.res_dropout(ffn_out, generator)
