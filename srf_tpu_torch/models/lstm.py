"""(B)LSTM CTC encoder (port of ``srf_tpu/models/lstm.py``).

Reference: tfsr/model/lstm_encoder.py:31-103 — optional CNN front end
("conv_feat") -> reshape -> input dropout -> N x { (B)LSTM(d_model)
("lstm%d"), for blstm the two directions merged ("ave", "sum", "mul", else
concatenated), LayerNorm(1e-6) ("ln%d"), inner dropout } -> Linear(vocab,
no bias) ("proj") -> length mask (``in_len_div``) -> LayerNorm ("ln_out").

Each layer is one ``nn.LSTM`` (cuDNN's RNN on the card; JAX runs the
recurrence as ``lax.scan``), bidirectional for blstm, whose output
[fwd, bwd] is split before the merge. Its gates are flax's
``OptimizedLSTMCell``'s in torch's i, f, g, o order: flax's per-gate input
kernels ``ii/if/ig/io`` [in, H] (no bias) are ``weight_ih`` [4H, in], its
recurrent kernels ``hi/hf/hg/ho`` [H, H] ``weight_hh`` [4H, H], and their
biases ``bias_hh``. flax has one bias where torch has two: ``bias_ih``
stays at zero and out of training (``requires_grad`` False), since two
trained biases would each move at Adam's rate, twice one bias's step.
The initial weights are drawn per gate block as flax draws them: input
kernels from ``init_name`` on [H, in] (fan_out H, not 4H), recurrent
kernels orthogonal on [H, H], biases zero.

Reference quirk kept: the RNNs run over the padded batch without lengths
(no ``pack_padded_sequence``), so the backward direction reads the trailing
pad frames first and every valid frame's backward state depends on the
batch's padded width, as in JAX (``srf_tpu/models/lstm.py:11-18``) and the
reference.
"""

import math

import torch
from torch import nn

from srf_tpu_torch.models.initializers import get_init
from srf_tpu_torch.models.layers import (ConvFrontEnd, Dropout, LayerNorm,
                                          Linear)
from srf_tpu_torch.ops.masking import feat_mask2

GATES = 4  # i, f, g, o


class LstmEncoder(nn.Module):
    def __init__(self, num_layers, d_model, vocab_n, feat_dim,
                 bidirectional=False, merge_mode="ave", input_dropout=0.1,
                 inner_dropout=0.1, init_name=None, is_cnnfe=False,
                 conv_layer_num=2, conv_filter_num=64, conv_stride=2,
                 generator=None):
        super().__init__()
        self.num_layers = num_layers
        self.d_model = d_model
        self.bidirectional = bidirectional
        self.merge_mode = merge_mode
        self.is_cnnfe = is_cnnfe
        self.conv_layer_num = conv_layer_num
        self.conv_stride = conv_stride
        in_dim = feat_dim
        if is_cnnfe:
            self.conv_feat = ConvFrontEnd(conv_layer_num, conv_filter_num,
                                          stride=conv_stride)
            for _ in range(conv_layer_num):
                in_dim = math.ceil(in_dim / conv_stride)
            in_dim *= conv_filter_num
        self.inp_dropout = Dropout(input_dropout)
        out_dim = d_model * (2 if bidirectional and merge_mode not in
                             ("ave", "sum", "mul") else 1)
        for idx in range(num_layers):
            lstm = nn.LSTM(in_dim, d_model, batch_first=True,
                           bidirectional=bidirectional)
            for name, param in lstm.named_parameters():
                if name.startswith("bias_ih"):
                    param.requires_grad_(False)
            setattr(self, "lstm%d" % idx, lstm)
            setattr(self, "ln%d" % idx, LayerNorm(out_dim, eps=1e-6))
            in_dim = out_dim
        self.inn_dropout = Dropout(inner_dropout)
        self.proj = Linear(out_dim, vocab_n, bias=False)
        self.ln_out = LayerNorm(vocab_n, eps=1e-6)
        self.reset_parameters(init_name, generator)

    @torch.no_grad()
    def reset_parameters(self, init_name, generator=None):
        """Initial weights as the flax model draws them (not its bits):
        see the module docstring; the front end's convs and ``proj`` from
        ``init_name``, the front end's biases zero, norms at 1 / 0."""
        init = get_init(init_name)
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                init(module.weight, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LSTM):
                for name, param in module.named_parameters():
                    if name.startswith("bias"):
                        nn.init.zeros_(param)
                        continue
                    for block in param.chunk(GATES, dim=0):
                        if name.startswith("weight_ih"):
                            init(block, generator)
                        else:
                            nn.init.orthogonal_(block, generator=generator)

    @classmethod
    def from_config(cls, config, vocab_n, **overrides):
        kwargs = dict(
            num_layers=config.model_encoder_num,
            d_model=config.model_dimension,
            vocab_n=vocab_n,
            feat_dim=config.feat_dim,
            bidirectional=config.model_type.lower() == "blstm",
            merge_mode=config.model_lstm_merge,
            input_dropout=config.train_inp_dropout,
            inner_dropout=config.train_inn_dropout,
            init_name=config.model_initializer,
            is_cnnfe=config.model_lstm_is_cnnfe,
            conv_layer_num=config.model_conv_layer_num,
            conv_filter_num=config.model_conv_filter_num,
            conv_stride=config.model_conv_stride,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @property
    def in_len_div(self):
        return self.conv_stride ** self.conv_layer_num if self.is_cnnfe else 1

    def _merge(self, fwd, bwd):
        if self.merge_mode == "ave":
            return (fwd + bwd) * 0.5
        if self.merge_mode == "sum":
            return fwd + bwd
        if self.merge_mode == "mul":
            return fwd * bwd
        return torch.cat([fwd, bwd], dim=-1)

    def forward(self, feats, input_lengths, generator=None):
        """feats [B, T, feat_dim], input_lengths [B] -> logits
        [B, T / in_len_div, vocab_n]; in training mode ``generator`` keys
        the dropout masks."""
        x = feats
        if self.is_cnnfe:
            x = self.conv_feat(x, input_lengths, generator)
            x = x.reshape(x.shape[0], x.shape[1], -1)
        x = self.inp_dropout(x, generator)
        for idx in range(self.num_layers):
            lstm = getattr(self, "lstm%d" % idx)
            if lstm.weight_ih_l0.dtype == torch.bfloat16:
                # --tpu-bf16: flax's cell carries its state in float32, so
                # its gates promote to float32; run the recurrence in
                # float32 on the bf16 weights' values
                x, _ = torch.func.functional_call(
                    lstm, {name: p.float()
                           for name, p in lstm.named_parameters()},
                    (x.float(),))
            else:
                x, _ = lstm(x)
            if self.bidirectional:
                x = self._merge(x[..., :self.d_model], x[..., self.d_model:])
            x = getattr(self, "ln%d" % idx)(x)
            x = self.inn_dropout(x, generator)
        x = feat_mask2(self.proj(x), input_lengths, self.in_len_div)
        return self.ln_out(x)
