"""Speech-Transformer CTC encoder, "STF" (port of ``srf_tpu/models/stf.py``).

Reference: the ``ConvEncoder`` defined inside tfsr/trainer_tf.py:39-118 —
CNN front end ("conv") -> reshape [B, T', F'·C] (channels last, as the JAX
layout) -> Linear(d_model) ("linear_projection") -> length mask ->
* sqrt(d_model) + positional encoding -> input dropout -> N x pre-LN
``EncoderBlock`` ("enc%d") -> LayerNorm ("ln") -> Linear(vocab) ("proj").
The attention mask is the padding bias (``ops/masking.get_padding_bias``)
and the optional distance penalty is the [1, T', T'] board of
``ops/attention_penalty.py``; both are per-batch arguments, which
``trainer_tf.make_stf_extra_kwargs`` computes from the padded width.
Without them (``Recognizer``, as JAX's) attention runs unmasked.

``attention_impl``: "plain" materializes the [B, H, T', T'] weights,
"blockwise" streams key blocks (``ops/blockwise_attention.py``) with the
closed-form penalty ``penalty_params`` (the dense board is dropped), and
"auto" chooses per batch shape as JAX does: in training blockwise when the
weights of one layer, 4·B·H·T'² bytes, exceed 6e8, in eval when T' >=
``auto_blockwise_len`` (2048). "ring" splits the time axis over the ranks
of ``group`` (``ops/ring_attention.py``), as JAX's takes ``mesh``; it is
programmatic only (the CLIs refuse it, as JAX's do).

Parameter names mirror the flax tree, so ``convert.py`` maps one onto the
other.
"""

import math

import torch
from torch import nn

from srf_tpu_torch.models.initializers import get_init, lecun_normal
from srf_tpu_torch.models.layers import (ConvFrontEnd, Dropout, EncoderBlock,
                                          LayerNorm, Linear)
from srf_tpu_torch.ops.attention_penalty import MAX_LEN, penalty_enabled
from srf_tpu_torch.ops.blockwise_attention import PenaltyParams
from srf_tpu_torch.ops.masking import feat_mask2
from srf_tpu_torch.ops.pos_enc import get_pos_enc

STAGES = ("all", "embed", "head")


class ConvEncoder(nn.Module):
    def __init__(self, num_layers, d_model, num_heads, dff, feat_dim,
                 vocab_n, input_dropout=0.1, inner_dropout=0.1,
                 residual_dropout=0.1, attention_dropout=0.1, nfilt=64,
                 cnn_n=2, init_name=None, stride=2, attention_impl="auto",
                 auto_blockwise_len=2048, penalty_params=None,
                 generator=None, group=None):
        super().__init__()
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.auto_blockwise_len = auto_blockwise_len
        self.penalty_params = penalty_params
        self.conv = ConvFrontEnd(cnn_n, nfilt, stride=stride)
        feat_out = feat_dim
        for _ in range(cnn_n):
            feat_out = -(-feat_out // stride)
        self.linear_projection = Linear(feat_out * nfilt, d_model)
        self.inp_dropout = Dropout(input_dropout)
        for i in range(num_layers):
            setattr(self, "enc%d" % i, EncoderBlock(
                d_model, num_heads, dff, inner_dropout, residual_dropout,
                attention_dropout, penalty_params=penalty_params, site=i,
                group=group))
        self.ln = LayerNorm(d_model, eps=1e-6)
        self.proj = Linear(d_model, vocab_n)
        self.reset_parameters(init_name, generator)

    @torch.no_grad()
    def reset_parameters(self, init_name, generator=None):
        """Initial weights as the flax model draws them (not its bits): the
        convs and every Linear but ``proj`` from ``init_name``, ``proj``
        from flax's default (``lecun_normal``), zero biases, norms at scale
        1 / offset 0."""
        init = get_init(init_name)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                (lecun_normal() if module is self.proj else init)(
                    module.weight, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)

    @classmethod
    def from_config(cls, config, vocab_n, **overrides):
        penalty_params = None
        # the gate of ops/attention_penalty.create_attention_penalty: the
        # plain path gets the dense board whenever the helper exists, so the
        # blockwise closed form must exist under the same condition
        if penalty_enabled(config):
            n_stripes = len(range(config.model_ap_width_zero - 1, MAX_LEN,
                                  config.model_ap_width_stripe))
            penalty_params = PenaltyParams(
                config.model_ap_width_zero, config.model_ap_width_stripe,
                config.model_ap_scale, n_stripes,
            )
        kwargs = dict(
            num_layers=config.model_encoder_num,
            d_model=config.model_dimension,
            num_heads=config.model_att_head_num,
            dff=config.model_inner_dim,
            feat_dim=config.feat_dim,
            vocab_n=vocab_n,
            input_dropout=config.train_inp_dropout,
            inner_dropout=config.train_inn_dropout,
            residual_dropout=config.train_res_dropout,
            attention_dropout=config.train_att_dropout,
            nfilt=config.model_conv_filter_num,
            cnn_n=config.model_conv_layer_num,
            init_name=config.model_initializer,
            penalty_params=penalty_params,
            attention_impl=getattr(config, "tpu_attention_kernel", "auto"),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def choose_impl(self, batch, seq_len):
        """The attention path for a batch of ``batch`` x ``seq_len`` (T')
        in the module's current mode."""
        impl = self.attention_impl
        if impl != "auto":
            return impl
        if self.training:
            weight_bytes = 4.0 * batch * self.num_heads * seq_len * seq_len
            return "blockwise" if weight_bytes > 6e8 else "plain"
        return ("blockwise" if seq_len >= self.auto_blockwise_len
                else "plain")

    def forward(self, feats, input_lengths=None, generator=None, mask=None,
                attention_penalty_mask=None, in_len_div=4, stage="all"):
        """feats [B, T, feat_dim] -> logits [B, T', vocab_n]. ``stage``
        splits the forward for a pipeline: "embed" runs the front end and
        returns ``(embeddings, impl)``; "head" takes block outputs as
        ``feats`` and runs the final LayerNorm and Linear; "all" is the
        whole forward."""
        if stage not in STAGES:
            raise ValueError(
                "unknown stage %r (expected 'all', 'embed' or 'head'); a "
                "typo here would silently run the head on raw features"
                % (stage,))
        if stage == "head":
            return self.proj(self.ln(feats))
        out = self.conv(feats, input_lengths, generator)
        batch, seq_len = out.shape[0], out.shape[1]
        out = self.linear_projection(out.reshape(batch, seq_len, -1))
        emb = feat_mask2(out, input_lengths, in_len_div)
        emb = emb * math.sqrt(float(self.d_model)) + get_pos_enc(
            seq_len, self.d_model, device=emb.device)
        emb = self.inp_dropout(emb, generator)
        impl = self.choose_impl(batch, seq_len)
        if stage == "embed":
            return emb, impl
        if impl in ("blockwise", "ring"):
            # the dense board is the plain path's input; blockwise
            # recomputes its values per tile from penalty_params
            attention_penalty_mask = None
        for i in range(self.num_layers):
            emb = getattr(self, "enc%d" % i)(
                emb, mask, attention_penalty_mask, generator, impl)
        return self.proj(self.ln(emb))
