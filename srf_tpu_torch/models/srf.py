"""SequenceRouter: the capsule-network SRF CTC acoustic model (port of
``srf_tpu/models/srf.py``, layered path, eval and training modes).

Forward pass (reference: sequence_router_naive.py:120-193):
    CNN front-end (maxout convs, 4x time subsample)
    -> reshape (channels-last, as the JAX layout) -> Linear(PH) ("flatten")
    [einsum flavor only: *sqrt(PH) + positional encoding]
    -> two parallel 3x3 Conv(PD) + dropout(0.2), maxout ("encaps")
    -> length-mask -> [B,T',PH,PD] -> squash -> flattened LayerNorm
    -> input dropout
    -> enc_num x { windowing -> routing (DR or SDR) -> flattened LayerNorm
                   -> dropout }
    -> logits = LayerNorm(||class capsules||)

Dropout acts in training mode only, at the JAX model's places and rates
(the encaps and front-end 0.2 are fixed there as here); its masks come from
the ``generator`` passed to ``forward`` (the train step seeds one per step),
else from the global RNG. The JAX wavefront, bf16 and time-chunk routing
paths are not ported (``models/registry.py`` refuses their flags).

Parameter names mirror the flax tree (conv_feat, flatten, encaps1/2,
ln_input, W%d/b%d, ln_mid%d, ln_output), so ``convert.py`` maps one onto the
other; W%d/b%d keep the JAX layouts [in_n, out_n, out_d, in_d] and
[in_n, out_n, out_d].

Only ``_capsulate`` masks by length: after the first routing layer, padded
frames hold non-zero capsules that the window's right context reads at the
last valid frame, so logits depend on the padded width exactly as in the
JAX package. Callers pad the same way.
"""

import math

import torch
from torch import nn

from srf_tpu_torch.models.initializers import get_init, routing_weight_init
from srf_tpu_torch.models.layers import ConvFrontEnd, Dropout
from srf_tpu_torch.ops.masking import feat_mask
from srf_tpu_torch.ops.pos_enc import get_pos_enc
from srf_tpu_torch.ops.routing import route_layer, window_stack
from srf_tpu_torch.ops.squash import capsule_length, squash


class SequenceRouter(nn.Module):
    def __init__(self, feat_dim, class_n, enc_num, caps_primary_num,
                 caps_primary_dim, caps_conv_num, caps_conv_dim,
                 caps_class_dim, caps_iter, lpad, rpad, is_context,
                 conv_layer_num=2, conv_filter_num=64, inp_dropout=0.1,
                 inn_dropout=0.1, init_name=None, caps_type="lowmemory",
                 stride=2, generator=None):
        super().__init__()
        self.feat_dim = feat_dim
        self.class_n = class_n
        self.enc_num = enc_num
        self.caps_primary_num = caps_primary_num
        self.caps_primary_dim = caps_primary_dim
        self.caps_conv_num = caps_conv_num
        self.caps_conv_dim = caps_conv_dim
        self.caps_class_dim = caps_class_dim
        self.caps_iter = caps_iter
        self.lpad = lpad
        self.rpad = rpad
        self.is_context = is_context
        self.conv_layer_num = conv_layer_num
        self.init_name = init_name
        self.caps_type = caps_type
        self.stride = stride

        self.conv_feat = ConvFrontEnd(conv_layer_num, conv_filter_num,
                                      stride=stride)
        feat_out = feat_dim
        for _ in range(conv_layer_num):
            feat_out = -(-feat_out // stride)
        self.flatten = nn.Linear(feat_out * conv_filter_num, caps_primary_num)
        self.encaps1 = nn.Conv2d(1, caps_primary_dim, 3, padding=1)
        self.encaps2 = nn.Conv2d(1, caps_primary_dim, 3, padding=1)
        self.ln_input = nn.LayerNorm(caps_primary_num * caps_primary_dim,
                                     eps=1e-3)
        for i, (in_n, out_n, out_d, in_d) in enumerate(self.layer_shapes()):
            self.register_parameter(
                "W%d" % i, nn.Parameter(torch.empty(in_n, out_n, out_d, in_d)))
            self.register_parameter(
                "b%d" % i, nn.Parameter(torch.empty(in_n, out_n, out_d)))
            setattr(self, "ln_mid%d" % (i + 1),
                    nn.LayerNorm(out_n * out_d, eps=1e-3))
        self.ln_output = nn.LayerNorm(class_n, eps=1e-3)
        self.drop_encaps = Dropout(0.2)
        self.drop_inp = Dropout(inp_dropout)
        self.drop_inn = Dropout(inn_dropout)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, config, class_n, **overrides):
        kwargs = dict(
            feat_dim=config.feat_dim,
            class_n=class_n,
            enc_num=config.model_encoder_num,
            caps_primary_num=config.model_caps_primary_num,
            caps_primary_dim=config.model_caps_primary_dim,
            caps_conv_num=config.model_caps_convolution_num,
            caps_conv_dim=config.model_caps_convolution_dim,
            caps_class_dim=config.model_caps_class_dim,
            caps_iter=config.model_caps_iter,
            lpad=config.model_caps_window_lpad,
            rpad=config.model_caps_window_rpad,
            is_context=config.model_caps_context,
            conv_layer_num=config.model_conv_layer_num,
            conv_filter_num=config.model_conv_filter_num,
            inp_dropout=config.train_inp_dropout,
            inn_dropout=config.train_inn_dropout,
            init_name=config.model_initializer,
            caps_type=config.model_caps_type,
            stride=config.model_conv_stride,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Initial weights as the flax model draws them (not its bits):
        convs and Linear from ``init_name`` with zero biases, routing W and
        b from normal(0, 0.1), norms at scale 1 / offset 0."""
        init = get_init(self.init_name)
        w_init = routing_weight_init()
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                init(module.weight, generator)
                nn.init.zeros_(module.bias)
        for i in range(self.enc_num):
            w_init(getattr(self, "W%d" % i), generator)
            w_init(getattr(self, "b%d" % i), generator)

    def layer_shapes(self):
        """[(in_n, out_n, out_d, in_d)] per capsule layer
        (reference: sequence_router_naive.py:88-95)."""
        window = self.lpad + self.rpad + 1
        ph, pd = self.caps_primary_num, self.caps_primary_dim
        ch, cd = self.caps_conv_num, self.caps_conv_dim
        vd = self.caps_class_dim
        if self.enc_num == 1:
            return [(ph * window, self.class_n, vd, pd)]
        shapes = [(ph * window, ch, cd, pd)]
        for _ in range(1, self.enc_num - 1):
            shapes.append((ch * window, ch, cd, cd))
        shapes.append((ch * window, self.class_n, vd, cd))
        return shapes

    def _capsulate(self, feats, input_lengths, generator=None):
        """Front-end through primary capsules: [B,T,feat] -> [B,T',PH,PD]."""
        conv_out = self.conv_feat(feats, input_lengths, generator)
        batch, seq_len = conv_out.shape[0], conv_out.shape[1]

        emb = self.flatten(conv_out.reshape(batch, seq_len, -1))
        if self.caps_type == "einsum":
            emb = emb * math.sqrt(float(self.caps_primary_num))
            emb = emb + get_pos_enc(seq_len, self.caps_primary_num,
                                    device=emb.device)
        x = emb[:, None]  # NCHW [B, 1, T', PH]
        emb = torch.maximum(self.drop_encaps(self.encaps1(x), generator),
                            self.drop_encaps(self.encaps2(x), generator))
        # the true subsampling divisor (the reference hardcodes stride**2;
        # identical at the default geometry, see srf_tpu/models/srf.py)
        emb = feat_mask(emb, input_lengths,
                        self.stride ** self.conv_layer_num, time_dim=2)

        emb = squash(emb.permute(0, 2, 3, 1), dim=-1)  # [B, T', PH, PD]
        flat = self.ln_input(emb.reshape(batch, seq_len, -1))
        emb = flat.reshape(batch, seq_len, self.caps_primary_num,
                           self.caps_primary_dim)
        return self.drop_inp(emb, generator)

    def output_block(self, emb):
        """Class capsules -> CTC logits (the model's output head)."""
        eps = 1e-9 if self.caps_type == "einsum" else 1e-7
        logits = capsule_length(emb, dim=-1, epsilon=eps)
        return self.ln_output(logits)

    def forward(self, feats, input_lengths, generator=None):
        """feats [B, T, feat_dim], input_lengths [B] -> logits
        [B, ceil(T/stride^n), class_n]. ``generator`` draws the dropout
        masks in training mode."""
        num_iter = 1 if self.caps_type == "lowmemory" else self.caps_iter

        emb = self._capsulate(feats, input_lengths, generator)
        batch, seq_len = emb.shape[0], emb.shape[1]
        for i, (in_n, out_n, out_d, in_d) in enumerate(self.layer_shapes()):
            emb = window_stack(emb, self.lpad, self.rpad)
            emb = route_layer(
                emb, getattr(self, "W%d" % i), getattr(self, "b%d" % i),
                num_iter, self.is_context,
                is_last_layer=(i == self.enc_num - 1),
            )
            flat = getattr(self, "ln_mid%d" % (i + 1))(
                emb.reshape(batch, seq_len, -1))
            emb = self.drop_inn(flat.reshape(batch, seq_len, out_n, out_d),
                                generator)
        return self.output_block(emb)
