"""The plain deep maxout CNN (Zhang et al., "Towards end-to-end speech
recognition with deep convolutional neural networks", arXiv:1701.02720, as
the recipe ``egs/script/train_cnn_timit.sh`` of
https://github.com/sephiroce/srf trains it), in plain PyTorch: the family
``cnn`` that a configuration names with ``"reference": "cnn"``.

This is the benchmark's reference for that family: it imports nothing of
the program (neither ``srf_tpu_torch`` nor the JAX package) and works
everything out again from the configuration's sizes, the weights and the
inputs the benchmark hands both sides. It runs in float32 with TF32 off
unless the caller turns TF32 on (the control, ``common.tf32(True)``), and
its convolutions run on cuDNN's heuristics, never its timed search
(``cudnn.benchmark`` off around them, their gradients included), so it
adds no search to a run.

Architecture, the maxpool variant (``cfg``: the ``model`` object of a file
in ``benchmark/configs/``), on activations laid out [B, T, F, C]:

- ``enc_num`` convolutions with (5, 3) kernels over (time, frequency) and
  no bias: ``conv_layer_num`` of ``nfilt_inp`` filters at time stride
  ``stride``, the rest of the first four at stride 1, ``enc_num - 5`` of
  ``nfilt_inn`` filters, and a last one of ``(proj_dim // (feat_dim //
  3)) * 2`` filters. Each pads as flax's SAME does (the odd pad after;
  with stride 1 the pads are (2, 2) and (1, 1)), then: dropout 0.2 (fixed,
  as in the recipe's model), maxout over the channels (the first half
  against the second), after the first convolution a max pool of (1, 3)
  over frequency (VALID: 123 bins to 41), a LayerNorm over the channels
  (eps 1e-6), dropout ``inn_dropout``, and the frames at or past
  ``ceil(len / d)`` zeroed, ``d`` being ``stride`` after the first
  convolution and ``stride ** 2`` after the others (the recipe's divisors,
  kept as it has them);
- flattened to [B, T', F' x C] (channels fastest), ``proj_num - 1``
  maxout projections: a dense layer without bias to ``proj_dim``, dropout
  0.2, maxout, a LayerNorm (eps 1e-6), dropout ``inn_dropout``, the mask
  at ``stride ** 2``;
- ``projv``: a dense layer without bias to ``2 class_n``, dropout
  ``inn_dropout``, maxout, a LayerNorm (eps 1e-6), the mask: the CTC
  logits, blank last.

Dropout draws its masks as the recipe's ``--tpu-dropout-kernel=pallas``
states them (``dropout_kernel`` "pallas"), for every rate above zero: each
site in the order above has a seed, splitmix64 of the update's seed
(``drop.generator.initial_seed()``, ``common.dropout_seed``) and the
site's ordinal; an element is kept where its uniform 32-bit word of the
Philox4x32-10 stream under that seed (Salmon et al., SC'11, Random123
constants; key the seed's two halves, counter ``(i // 4, 0, 0, 0)`` split
in halves, word ``i % 4`` for element ``i`` of the site's row-major [B, T,
F, C] or [B, T, D] index) is at least ``min(round(rate 2**32), 2**32 -
1)``, and is then scaled by ``1 / (1 - rate)`` rounded to float32.

Departures from the published model: none in the mathematics. The
masks' stream is the one the configuration states, not the paper's
framework's; the weights are the benchmark's seeded draw, not a trained
model's.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.counts import cnn_flops as counts

# the CPU tests' sizes (``benchmark/tests/tiny.py``): no LayerNorm under 8
# channels (a LayerNorm over 2 channels at eps 1e-6 makes float32 parity
# chaotic)
TINY = {"feat_dim": 9, "nfilt_inp": 16, "nfilt_inn": 16, "proj_dim": 24}

# each model key's flag in a configuration's ``argv``
FLAGS = {"model_type": "model-type", "is_mp": "model-conv-is-mp",
         "feat_dim": "feat-dim", "enc_num": "model-encoder-num",
         "nfilt_inp": "model-conv-inp-nfilt",
         "nfilt_inn": "model-conv-inn-nfilt",
         "proj_num": "model-conv-proj-num",
         "proj_dim": "model-conv-proj-dim",
         "conv_layer_num": "model-conv-layer-num",
         "stride": "model-conv-stride", "inn_dropout": "train-inn-dropout",
         "dropout_kernel": "tpu-dropout-kernel"}

CONV_RATE = 0.2
LN_EPS = 1e-6
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def _filters(cfg):
    return counts.layer_filters(
        cfg["feat_dim"], cfg["enc_num"], cfg["nfilt_inp"], cfg["nfilt_inn"],
        cfg["proj_dim"], cfg["conv_layer_num"], cfg["stride"])


def subsample(cfg):
    """Input frames a logit frame: the time strides' product."""
    return cfg["stride"] ** cfg["conv_layer_num"]


def param_shapes(cfg):
    """{name: (shape, kind)} of every weight, in the program's state-dict
    names (convolution weights [out, in, 5, 3], dense weights [out, in])."""
    filters, pooled, last = _filters(cfg)
    shapes, in_c = {}, 1
    for idx, (out_c, _) in enumerate(filters):
        shapes["body.conv%d.weight" % idx] = ((out_c, in_c, 5, 3), "fan_in")
        shapes["body.ln%d.weight" % idx] = ((out_c // 2,), "scale")
        shapes["body.ln%d.bias" % idx] = ((out_c // 2,), "bias")
        in_c = out_c // 2
    in_dim = pooled * (last // 2)
    for idx in range(cfg["proj_num"] - 1):
        shapes["body.proj%d.weight" % idx] = ((cfg["proj_dim"], in_dim),
                                              "fan_in")
        shapes["body.proj_ln%d.weight" % idx] = ((cfg["proj_dim"] // 2,),
                                                 "scale")
        shapes["body.proj_ln%d.bias" % idx] = ((cfg["proj_dim"] // 2,),
                                               "bias")
        in_dim = cfg["proj_dim"] // 2
    shapes["body.projv.weight"] = ((2 * cfg["class_n"], in_dim), "fan_in")
    shapes["body.projv_ln.weight"] = ((cfg["class_n"],), "scale")
    shapes["body.projv_ln.bias"] = ((cfg["class_n"],), "bias")
    return shapes


def trained_names(cfg):
    """Every weight is trained: the model keeps no statistics."""
    return list(param_shapes(cfg))


def same_pads(length, kernel, stride):
    """(before, after) of flax's SAME padding of one axis."""
    total = max((math.ceil(length / stride) - 1) * stride + kernel - length,
                0)
    return total // 2, total - total // 2


def _mulhilo(a, multiplier):
    """(high, low) 32-bit words of ``a * multiplier`` for an int64 tensor
    of uint32 values: the multiplier split in 16-bit halves keeps every
    partial product below 2**49."""
    m_hi, m_lo = multiplier >> 16, multiplier & 0xFFFF
    p_hi = a * m_hi
    low = ((p_hi & 0xFFFF) << 16) + a * m_lo
    return (p_hi >> 16) + (low >> 32), low & _MASK32


def philox_words(numel, seed, device):
    """The first ``numel`` uint32 words (as int64) of Philox4x32-10 under
    ``seed``: counter ``(g, g >> 32, 0, 0)`` gives words ``4g .. 4g + 3``."""
    groups = -(-numel // 4)
    c0 = torch.arange(groups, dtype=torch.int64, device=device)
    c1 = c0 >> 32
    c0 = c0 & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:numel]


def site_seed(base, index):
    """Site ``index``'s seed under the update's ``base``: splitmix64 of
    ``base + (index + 1) * golden``."""
    z = (base + (index + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class Sites:
    """One forward's dropout sites, numbered in the order they run; without
    an update's dropout (eval) each is the identity."""

    def __init__(self, drop):
        generator = getattr(drop, "generator", None)
        self.base = None if generator is None else generator.initial_seed()
        self.count = 0

    def __call__(self, x, rate):
        index, self.count = self.count, self.count + 1
        if self.base is None or rate <= 0.0:
            return x
        threshold = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
        scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()
        bits = philox_words(x.numel(), site_seed(self.base, index),
                            x.device).reshape(x.shape)
        return torch.where(bits >= threshold, x * scale, torch.zeros_like(x))


def length_mask(x, lengths, divisor):
    """``x`` [B, T, ...] with the frames at or past ceil(len / divisor)
    zeroed."""
    valid = torch.ceil(torch.as_tensor(lengths).to(torch.float32)
                       / divisor).to(x.device)
    keep = (torch.arange(x.shape[1], device=x.device)[None, :]
            < valid[:, None]).to(x.dtype)
    return x * keep.reshape(keep.shape + (1,) * (x.dim() - 2))


def maxout(x):
    half = x.shape[-1] // 2
    return torch.maximum(x[..., :half], x[..., half:])


class _Heuristic:
    """cuDNN's heuristics, not its timed search, inside the block."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        torch.backends.cudnn.benchmark = self.saved


class _Conv(torch.autograd.Function):
    """``F.conv2d`` without bias whose backward, too, runs on cuDNN's
    heuristics (autograd runs it later, in a thread of its own)."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        with _Heuristic():
            return F.conv2d(x, weight, None, stride)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        grad_x = grad_w = None
        with _Heuristic():
            if ctx.needs_input_grad[0]:
                grad_x = torch.nn.grad.conv2d_input(x.shape, weight, grad,
                                                    ctx.stride)
            if ctx.needs_input_grad[1]:
                grad_w = torch.nn.grad.conv2d_weight(x, weight.shape, grad,
                                                     ctx.stride)
        return grad_x, grad_w, None


def conv(x, weight, t_stride):
    """(5, 3) convolution of [B, T, F, C] with flax's SAME padding, in
    NCHW, on cuDNN's heuristics in the forward and the backward."""
    nchw = x.permute(0, 3, 1, 2).contiguous()
    t_pad = same_pads(nchw.shape[2], 5, t_stride)
    f_pad = same_pads(nchw.shape[3], 3, 1)
    nchw = F.pad(nchw, [*f_pad, *t_pad])
    return _Conv.apply(nchw, weight, (t_stride, 1)).permute(0, 2, 3, 1)


def forward(p, feats, lengths, cfg, drop=None, training=False):
    """CTC logits [B, T', class_n] of padded ``feats`` [B, T, feat_dim] with
    ``lengths`` [B] (host). ``drop``: the update's ``common.Dropout`` in
    training, whose generator's seed keys the masks."""
    sites = Sites(drop if training else None)
    stride, inner = cfg["stride"], cfg["inn_dropout"]
    emb = feats[..., None]
    filters, _, _ = _filters(cfg)
    for idx, (out_c, t_stride) in enumerate(filters):
        emb = maxout(sites(conv(emb, p["body.conv%d.weight" % idx],
                                t_stride), CONV_RATE))
        if idx == 0:
            # max over each frequency triple, a partial last one dropped
            batch, steps, width, chans = emb.shape
            emb = emb[:, :, :width // 3 * 3].reshape(
                batch, steps, width // 3, 3, chans).amax(dim=3)
        emb = F.layer_norm(emb, (emb.shape[-1],), p["body.ln%d.weight" % idx],
                           p["body.ln%d.bias" % idx], LN_EPS)
        emb = length_mask(sites(emb, inner), lengths,
                          stride if idx == 0 else stride * stride)
    batch, steps = emb.shape[:2]
    emb = emb.reshape(batch, steps, -1)
    for idx in range(cfg["proj_num"] - 1):
        emb = maxout(sites(F.linear(emb, p["body.proj%d.weight" % idx]),
                           CONV_RATE))
        emb = F.layer_norm(emb, (emb.shape[-1],),
                           p["body.proj_ln%d.weight" % idx],
                           p["body.proj_ln%d.bias" % idx], LN_EPS)
        emb = length_mask(sites(emb, inner), lengths, stride * stride)
    emb = maxout(sites(F.linear(emb, p["body.projv.weight"]), inner))
    emb = F.layer_norm(emb, (cfg["class_n"],), p["body.projv_ln.weight"],
                       p["body.projv_ln.bias"], LN_EPS)
    return length_mask(emb, lengths, stride * stride)


def _count_kwargs(cfg):
    return dict(feat_dim=cfg["feat_dim"], enc_num=cfg["enc_num"],
                nfilt_inp=cfg["nfilt_inp"], nfilt_inn=cfg["nfilt_inn"],
                proj_dim=cfg["proj_dim"],
                conv_layer_num=cfg["conv_layer_num"], stride=cfg["stride"])


def forward_flops(batch, frames, cfg):
    """Model FLOPs of one forward over ``batch`` rows of ``frames`` frames
    (``counts.cnn_flops.cnn_maxpool_forward_flops``)."""
    return counts.cnn_maxpool_forward_flops(
        batch, frames, class_n=cfg["class_n"], proj_layers=cfg["proj_num"],
        **_count_kwargs(cfg))


def train_step_flops(batch, frames, cfg):
    """Model FLOPs of one train step: 3 x the forward, no recompute."""
    return 3.0 * forward_flops(batch, frames, cfg)


def conv_calls(batch, frames, cfg):
    """The convolution calls of one train step (``counts.cnn_flops``)."""
    return counts.conv_calls(batch, frames, **_count_kwargs(cfg))


def dropout_sites(batch, frames, cfg):
    """Elements of each dropout site of one forward, rate above zero or
    not (``counts.cnn_flops``), with each site's rate."""
    sizes = counts.dropout_sites(
        batch, frames, class_n=cfg["class_n"], proj_layers=cfg["proj_num"],
        **_count_kwargs(cfg))
    rates = []
    for _ in range(cfg["enc_num"] + cfg["proj_num"] - 1):
        rates += [CONV_RATE, cfg["inn_dropout"]]
    return list(zip(sizes, rates + [cfg["inn_dropout"]]))
