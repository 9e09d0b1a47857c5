"""Deep maxout CNN CTC encoders (port of ``srf_tpu/models/cnn.py``; Zhang
et al. 2016, arXiv:1701.02720).

Two variants, chosen by ``--model-conv-is-mp`` (``models/registry.py``):

- :class:`CNNEncoder` (maxpool variant): (5, 3) convs without bias, each
  followed by dropout 0.2, channel-halving maxout, LayerNorm over the
  channels (eps 1e-6), inner dropout and the length mask; time stride on
  the first ``conv_layer_num`` convs; MaxPool (1, 3) over frequency after
  conv 0; then ``proj_layers - 1`` maxout projections (Linear without
  bias, dropout 0.2, maxout, LayerNorm, inner dropout, mask) and ``projv``,
  a maxout projection to ``class_n``.
- :class:`CNNStrideEncoder`: the same body fed by ``ConvFrontEnd`` (the
  SRF front end, stride 2 fixed) and an input dropout.

Activations keep the JAX layout [B, T, F, C] between layers, so the
flatten before the projections reads the same order; each convolution runs
on an NCHW view of it (the channels-last memory layout), and its output is
viewed back, so no layer copies its input to change the layout.

Dropout (``--tpu-dropout-kernel``): ``xla`` draws each site's mask from the
``generator`` the train step seeds (``layers.Dropout``); ``pallas`` runs
K5 (``ops.dropout.fused_dropout``) at every site of the body and at the
stride variant's input dropout, each keyed by a host integer: the
generator's seed (``generator.initial_seed()``, which the train step sets
per step, so a caller that passes one generator to several forwards
without reseeding it gets the same masks) mixed with the site's ordinal in
the forward. Nothing is read back from the card, and the same step on the
card and on the CPU draws the same K5 masks. ``ConvFrontEnd`` keeps its
own hard-coded 0.2 dropout through ``layers.Dropout`` in both modes, as in
JAX. A site's rate is its ``Dropout`` module's ``p`` in both modes, so
setting every ``p`` to 0 turns dropout off. ``models/registry.py`` refuses
any other value of the flag.

Reference quirks kept: the length-mask divisor is ``stride`` after conv 0
and ``stride * stride`` after the rest in the maxpool variant, and
``conv_layer_num ** 2`` throughout the stride variant; the 0.2 rates after
each conv and each projection are fixed; ``enc_num < 5`` raises.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from srf_tpu_torch.models.initializers import get_init
from srf_tpu_torch.models.layers import ConvFrontEnd, Dropout, conv2d_same
from srf_tpu_torch.ops.dropout import fused_dropout, site_seed
from srf_tpu_torch.ops.masking import feat_mask, feat_mask2


def _channel_maxout(x):
    dim = x.shape[-1] // 2
    return torch.maximum(x[..., :dim], x[..., dim:])


def _check_config(enc_num, conv_layer_num):
    if conv_layer_num >= 4:
        raise ValueError("the maxout CNN needs --model-conv-layer-num < 4 "
                         "(got %d)" % conv_layer_num)
    if enc_num < 5:
        # the reference architecture has 4 fixed input convs and a final
        # projection conv
        raise ValueError("the maxout CNN needs --model-encoder-num >= 5 "
                         "(got %d)" % enc_num)


class _DropoutSites:
    """One forward's dropout sites, called in the order they run."""

    def __init__(self, impl, generator):
        self.impl = impl
        self.generator = generator
        self.count = 0
        self._base = None

    def __call__(self, x, module):
        if self.impl == "xla":
            return module(x, self.generator)
        index, self.count = self.count, self.count + 1
        if not module.training or module.p <= 0.0:
            return x
        return fused_dropout(x, site_seed(self._base_seed(), index), module.p)

    def _base_seed(self):
        if self._base is None:
            # without a generator, a draw of the global CPU generator
            self._base = (self.generator.initial_seed()
                          if self.generator is not None
                          else int(torch.randint(1 << 62, ()).item()))
        return self._base


class _MaxoutConvStack(nn.Module):
    """Shared conv + projection body of both CNN variants."""

    def __init__(self, in_channels, layer_filters, proj_layers, proj_dim,
                 class_n, flat_dim, mask_div_fn, inner_dropout,
                 pool_after_first=False):
        super().__init__()
        self.strides = [t_stride for _, t_stride in layer_filters]
        self.flat_dim = flat_dim
        self.mask_div_fn = mask_div_fn
        self.pool_after_first = pool_after_first
        for idx, (filters, _) in enumerate(layer_filters):
            setattr(self, "conv%d" % idx,
                    nn.Conv2d(in_channels, filters, (5, 3), bias=False))
            setattr(self, "ln%d" % idx, nn.LayerNorm(filters // 2, eps=1e-6))
            in_channels = filters // 2
        self.proj_num = proj_layers - 1
        in_dim = flat_dim
        for idx in range(self.proj_num):
            setattr(self, "proj%d" % idx,
                    nn.Linear(in_dim, proj_dim, bias=False))
            setattr(self, "proj_ln%d" % idx,
                    nn.LayerNorm(proj_dim // 2, eps=1e-6))
            in_dim = proj_dim // 2
        self.projv = nn.Linear(in_dim, class_n * 2, bias=False)
        self.projv_ln = nn.LayerNorm(class_n, eps=1e-6)
        self.drop_conv = Dropout(0.2)  # fixed, as in the reference
        self.drop_inn = Dropout(inner_dropout)

    def forward(self, emb, input_lengths, drop):
        """emb [B, T, F, C] -> logits [B, T', class_n]; ``drop`` is the
        forward's ``_DropoutSites``."""
        for idx, t_stride in enumerate(self.strides):
            conv = getattr(self, "conv%d" % idx)
            emb = conv2d_same(emb.permute(0, 3, 1, 2), conv.weight,
                              (t_stride, 1)).permute(0, 2, 3, 1)
            emb = _channel_maxout(drop(emb, self.drop_conv))
            if self.pool_after_first and idx == 0:
                emb = F.max_pool2d(emb.permute(0, 3, 1, 2), (1, 3),
                                   (1, 3)).permute(0, 2, 3, 1)
            emb = drop(getattr(self, "ln%d" % idx)(emb), self.drop_inn)
            emb = feat_mask(emb, input_lengths, self.mask_div_fn(idx))

        batch, seq_len = emb.shape[0], emb.shape[1]
        emb = emb.reshape(batch, seq_len, self.flat_dim)
        for idx in range(self.proj_num):
            emb = drop(getattr(self, "proj%d" % idx)(emb), self.drop_conv)
            emb = getattr(self, "proj_ln%d" % idx)(_channel_maxout(emb))
            emb = drop(emb, self.drop_inn)
            emb = feat_mask2(emb, input_lengths, self.mask_div_fn(1))

        emb = drop(self.projv(emb), self.drop_inn)
        emb = self.projv_ln(_channel_maxout(emb))
        return feat_mask2(emb, input_lengths, self.mask_div_fn(1))


class _CNNBase(nn.Module):
    @torch.no_grad()
    def reset_parameters(self, init_name, generator=None):
        """Initial weights as the flax model draws them (not its bits):
        convs and Linear from ``init_name`` (the front end's biases zero),
        norms at scale 1 / offset 0."""
        init = get_init(init_name)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                init(module.weight, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)


class CNNEncoder(_CNNBase):
    """Maxpool variant (``--model-conv-is-mp=True``): [B, T, feat_dim] ->
    [B, T', class_n] with T' = T / stride^conv_layer_num (ceil)."""

    def __init__(self, enc_num, class_n, feat_dim, nfilt_inp=64,
                 nfilt_inn=128, proj_layers=3, proj_dim=512,
                 conv_layer_num=2, stride=2, inner_dropout=0.1,
                 init_name=None, dropout_impl="xla", generator=None):
        super().__init__()
        _check_config(enc_num, conv_layer_num)
        self.dropout_impl = dropout_impl
        pooled_dim = feat_dim // 3
        last_filt = (proj_dim // pooled_dim) * 2
        layer_filters = [(nfilt_inp, stride)] * conv_layer_num
        layer_filters += [(nfilt_inp, 1)] * (4 - conv_layer_num)
        layer_filters += [(nfilt_inn, 1)] * (enc_num - 5)
        layer_filters.append((last_filt, 1))
        self.body = _MaxoutConvStack(
            1, layer_filters, proj_layers, proj_dim, class_n,
            flat_dim=pooled_dim * (last_filt // 2),
            mask_div_fn=lambda idx: stride if idx == 0 else stride * stride,
            inner_dropout=inner_dropout, pool_after_first=True)
        self.reset_parameters(init_name, generator)

    @classmethod
    def from_config(cls, config, class_n, **overrides):
        kwargs = dict(
            enc_num=config.model_encoder_num,
            class_n=class_n,
            feat_dim=config.feat_dim,
            nfilt_inp=config.model_conv_inp_nfilt,
            nfilt_inn=config.model_conv_inn_nfilt,
            proj_layers=config.model_conv_proj_num,
            proj_dim=config.model_conv_proj_dim,
            conv_layer_num=config.model_conv_layer_num,
            stride=config.model_conv_stride,
            inner_dropout=config.train_inn_dropout,
            init_name=config.model_initializer,
            dropout_impl=getattr(config, "tpu_dropout_kernel", "xla"),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, feats, input_lengths, generator=None):
        """feats [B, T, feat_dim], input_lengths [B] -> logits; in
        training mode ``generator`` keys the dropout masks."""
        drop = _DropoutSites(self.dropout_impl, generator)
        return self.body(feats[..., None], input_lengths, drop)


class CNNStrideEncoder(_CNNBase):
    """Stride variant (``--model-conv-is-mp=False``): ``ConvFrontEnd`` (4x
    time subsampling) + input dropout + the maxout body."""

    def __init__(self, enc_num, class_n, feat_dim, nfilt_inp=64,
                 nfilt_inn=128, proj_layers=3, proj_dim=512,
                 conv_layer_num=2, conv_filter_num=64, input_dropout=0.1,
                 inner_dropout=0.1, init_name=None, dropout_impl="xla",
                 generator=None):
        super().__init__()
        _check_config(enc_num, conv_layer_num)
        self.dropout_impl = dropout_impl
        stride = 2  # the reference hard-codes stride 2 for the front end
        fe_dim = math.ceil(feat_dim / stride ** conv_layer_num)
        last_filt = (proj_dim // fe_dim) * 2
        layer_filters = [(nfilt_inp, 1)] * 4
        layer_filters += [(nfilt_inn, 1)] * (enc_num - 5)
        layer_filters.append((last_filt, 1))
        mask_div = conv_layer_num ** stride  # reference quirk
        self.conv_feat = ConvFrontEnd(conv_layer_num, conv_filter_num,
                                      stride=stride)
        self.drop_inp = Dropout(input_dropout)
        self.body = _MaxoutConvStack(
            conv_filter_num, layer_filters, proj_layers, proj_dim, class_n,
            flat_dim=fe_dim * (last_filt // 2),
            mask_div_fn=lambda idx: mask_div, inner_dropout=inner_dropout)
        self.reset_parameters(init_name, generator)

    @classmethod
    def from_config(cls, config, class_n, **overrides):
        kwargs = dict(
            enc_num=config.model_encoder_num,
            class_n=class_n,
            feat_dim=config.feat_dim,
            nfilt_inp=config.model_conv_inp_nfilt,
            nfilt_inn=config.model_conv_inn_nfilt,
            proj_layers=config.model_conv_proj_num,
            proj_dim=config.model_conv_proj_dim,
            conv_layer_num=config.model_conv_layer_num,
            conv_filter_num=config.model_conv_filter_num,
            input_dropout=config.train_inp_dropout,
            inner_dropout=config.train_inn_dropout,
            init_name=config.model_initializer,
            dropout_impl=getattr(config, "tpu_dropout_kernel", "xla"),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, feats, input_lengths, generator=None):
        """feats [B, T, feat_dim], input_lengths [B] -> logits; in
        training mode ``generator`` keys the dropout masks."""
        drop = _DropoutSites(self.dropout_impl, generator)
        emb = self.conv_feat(feats, input_lengths, generator)
        return self.body(drop(emb, self.drop_inp), input_lengths, drop)
