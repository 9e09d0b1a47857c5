"""Transformer decoder blocks (port of ``srf_tpu/models/decoder.py``).

The reference ships, but its CTC trainers never wire, a ``DecoderBlock``
with masked self-attention and cross-attention and an ``EncoderMFBlock``
multi-feature variant (reference: tfsr/model/block.py:75-210); no CLI
builds them here either. Both are pre-LN blocks on ``MultiHeadAttention``
and ``PointWiseFeedForward`` (``models/layers.py``), LayerNorm eps 1e-6,
parameter names as in the flax tree. flax creates ``ln_raw`` / ``ln_pre``
only when the block is called with a second stream; here ``with_raw`` /
``with_pre`` say whether the block has one.
"""

import torch
from torch import nn

from srf_tpu_torch.models.initializers import get_init
from srf_tpu_torch.models.layers import (
    Dropout, MultiHeadAttention, PointWiseFeedForward,
)


class _Block(nn.Module):
    @torch.no_grad()
    def reset_parameters(self, init_name, generator=None):
        """Linear weights from ``init_name``, zero biases, norms at 1 / 0."""
        init = get_init(init_name)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                init(module.weight, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)


class EncoderMFBlock(_Block):
    """Multi-feature encoder block (reference: block.py:75-141):
    self-attention on the feature stream, cross-attention against the raw
    stream (or the feature stream again without one), a projected
    residual, then the FFN."""

    def __init__(self, d_model, num_heads, dff, inner_dropout,
                 residual_dropout, attention_dropout, init_name=None,
                 with_raw=True, generator=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        if with_raw:
            self.ln_raw = nn.LayerNorm(d_model, eps=1e-6)
        self.mha1 = MultiHeadAttention(d_model, num_heads, attention_dropout,
                                       site=0)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.mha2 = MultiHeadAttention(d_model, num_heads, attention_dropout,
                                       site=1)
        self.proj = nn.Linear(d_model, d_model, bias=False)
        self.ln3 = nn.LayerNorm(d_model, eps=1e-6)
        self.ffn = PointWiseFeedForward(d_model, dff, inner_dropout)
        self.res_dropout = Dropout(residual_dropout)
        self.reset_parameters(init_name, generator)

    def forward(self, raw_emb, feat_emb, mask, attention_penalty_mask,
                generator=None):
        norm_feat = self.ln1(feat_emb)
        norm_raw = feat_emb if raw_emb is None else self.ln_raw(raw_emb)
        attn1, _ = self.mha1(norm_feat, norm_feat, norm_feat, mask,
                             attention_penalty_mask, generator)
        out1 = self.res_dropout(attn1, generator) + feat_emb
        attn2, _ = self.mha2(norm_raw, norm_raw, self.ln2(out1), mask,
                             attention_penalty_mask, generator)
        out2 = self.proj(self.res_dropout(attn2, generator)) + out1
        ffn_out = self.ffn(self.ln3(out2), generator)
        return self.res_dropout(ffn_out, generator) + out2


class DecoderBlock(_Block):
    """Masked self-attention over the previous stream (or the current one
    without it), cross-attention against the encoder output, FFN. Returns
    (output, self-attention weights, cross-attention weights)."""

    def __init__(self, d_model, num_heads, dff, inner_dropout,
                 residual_dropout, attention_dropout, init_name=None,
                 with_pre=True, generator=None):
        super().__init__()
        self.ln_cur = nn.LayerNorm(d_model, eps=1e-6)
        if with_pre:
            self.ln_pre = nn.LayerNorm(d_model, eps=1e-6)
        self.mha1 = MultiHeadAttention(d_model, num_heads, attention_dropout,
                                       site=0)
        self.ln_com = nn.LayerNorm(d_model, eps=1e-6)
        self.mha2 = MultiHeadAttention(d_model, num_heads, attention_dropout,
                                       site=1)
        self.ln_res = nn.LayerNorm(d_model, eps=1e-6)
        self.ffn = PointWiseFeedForward(d_model, dff, inner_dropout)
        self.res_dropout = Dropout(residual_dropout)
        self.reset_parameters(init_name, generator)

    def forward(self, cur_emb, pre_emb, enc_out, look_ahead_mask,
                padding_mask, dec_att_pen, enc_dec_att_pen, generator=None):
        norm_cur = self.ln_cur(cur_emb)
        norm_pre = norm_cur if pre_emb is None else self.ln_pre(pre_emb)
        attn1, w1 = self.mha1(norm_pre, norm_pre, norm_cur, look_ahead_mask,
                              dec_att_pen, generator)
        out1 = self.res_dropout(attn1, generator) + cur_emb
        attn2, w2 = self.mha2(enc_out, enc_out, self.ln_com(out1),
                              padding_mask, enc_dec_att_pen, generator)
        out2 = self.res_dropout(attn2, generator) + out1
        ffn_out = self.ffn(self.ln_res(out2), generator)
        return self.res_dropout(ffn_out, generator) + out2, w1, w2
