"""The plain SRF (the capsule CTC acoustic model of "Sequential Routing
Framework: fully capsule network-based speech recognition", as the
recipes ``egs/script/train_srf_{timit,wsj}.sh`` of
https://github.com/sephiroce/srf run it), in plain PyTorch: the family
``srf`` that a configuration names with ``"reference": "srf"``.

This is the benchmark's reference for that family: it imports nothing of
the program (neither ``srf_tpu_torch`` nor the JAX package) and works
everything out again from the configuration's sizes, the weights and the
inputs the benchmark hands both sides. What every family shares (the
dropout stream, CTC, Adam/Noam, greedy CTC, TF32) is in ``common.py``. It
runs in float32 with TF32 off unless the caller turns TF32 on (the
control, ``common.tf32(True)``).

Architecture, per configuration (``cfg``: the ``model`` object of a file in
``benchmark/configs/``):

- front end: ``conv_layer_num`` layers, each two parallel 3x3 stride-2
  convolutions with flax's SAME padding, each followed by dropout 0.2,
  joined by an elementwise max; the frames past each utterance's
  ``ceil(len / stride^(l+1))`` zeroed; BatchNorm (eps 1e-3; in training on
  the batch's mean and biased variance over (B, T', F'), padding included;
  in eval on its running statistics); the frames zeroed again;
- ``flatten``: a dense layer from (F' x filters, filters fastest) to PH;
- ``encaps``: two parallel 3x3 convolutions (padding 1) from one channel to
  PD over the [T', PH] grid, each with dropout 0.2, max-joined, padded
  frames zeroed, squashed over PD, a LayerNorm (eps 1e-3) over PH x PD,
  then dropout ``inp_dropout``;
- ``enc_num`` capsule layers: the window of ``lpad`` past and ``rpad``
  future frames (zero-padded at the edges) stacked along the capsule axis,
  sequential dynamic routing (SDR: a loop over time whose routing logits
  start from the agreement with the previous frame's output capsules;
  ``num_iter`` iterations; the PAD class, capsule 0, masked with -1e9 in
  the last layer), a LayerNorm (eps 1e-3) over out_n x out_d, dropout
  ``inn_dropout``;
- output: each class capsule's length ``sqrt(|v|^2 + 1e-7)``, then a
  LayerNorm (eps 1e-3) over the classes: the CTC logits, blank last.

Dropout (training only) draws ``common.Dropout``'s stream at each site in
the order above (in the front end the first convolution's before the
second's).
"""

import math

import torch
import torch.nn.functional as F

from benchmark.counts import flops as counts
from benchmark.reference.common import Dropout

NEG_INF = -1e9

# the CPU tests' sizes (``benchmark/tests/tiny.py``)
TINY = {"feat_dim": 8, "enc_num": 3, "caps_primary_num": 4,
        "caps_primary_dim": 4, "caps_conv_num": 4, "caps_conv_dim": 4,
        "caps_class_dim": 4, "conv_filter_num": 4}

# each model key's flag in a configuration's ``argv``
FLAGS = {"feat_dim": "feat-dim", "enc_num": "model-encoder-num",
         "caps_primary_num": "model-caps-primary-num",
         "caps_primary_dim": "model-caps-primary-dim",
         "caps_conv_num": "model-caps-convolution-num",
         "caps_conv_dim": "model-caps-convolution-dim",
         "caps_class_dim": "model-caps-class-dim",
         "caps_iter": "model-caps-iter", "caps_type": "model-caps-type",
         "lpad": "model-caps-window-lpad", "rpad": "model-caps-window-rpad",
         "is_context": "model-caps-context",
         "conv_layer_num": "model-conv-layer-num",
         "conv_filter_num": "model-conv-filter-num",
         "stride": "model-conv-stride",
         "inp_dropout": "train-inp-dropout",
         "inn_dropout": "train-inn-dropout"}


def num_iter(cfg):
    """Routing iterations: one for ``lowmemory`` capsules (the
    low-memory SDR routes once), ``caps_iter`` for the others."""
    return 1 if cfg["caps_type"] == "lowmemory" else cfg["caps_iter"]


def front_end_width(cfg):
    """F', the feature axis after the front end's strided convolutions."""
    width = cfg["feat_dim"]
    for _ in range(cfg["conv_layer_num"]):
        width = -(-width // cfg["stride"])
    return width


def subsample(cfg):
    """The front end's time divisor, stride^layers."""
    return cfg["stride"] ** cfg["conv_layer_num"]


def layer_shapes(cfg):
    """[(in_n, out_n, out_d, in_d)] of the capsule layers."""
    window = cfg["lpad"] + cfg["rpad"] + 1
    ph, pd = cfg["caps_primary_num"], cfg["caps_primary_dim"]
    ch, cd = cfg["caps_conv_num"], cfg["caps_conv_dim"]
    vd, classes = cfg["caps_class_dim"], cfg["class_n"]
    if cfg["enc_num"] == 1:
        return [(ph * window, classes, vd, pd)]
    shapes = [(ph * window, ch, cd, pd)]
    shapes += [(ch * window, ch, cd, cd)] * (cfg["enc_num"] - 2)
    shapes.append((ch * window, classes, vd, cd))
    return shapes


def param_shapes(cfg):
    """{name: (shape, kind)} of every weight and statistic, in the layout
    the configuration names them (the flax tree's names; convolution
    weights [out, in, kh, kw], dense weights [out, in], routing W
    [in_n, out_n, out_d, in_d] and b [in_n, out_n, out_d]). ``kind`` says
    how the benchmark draws it (``benchmark/weights.py``)."""
    shapes = {}
    nfilt, in_ch = cfg["conv_filter_num"], 1
    for layer in range(cfg["conv_layer_num"]):
        for branch in range(2):
            name = "conv_feat.conv%d_%d" % (layer, branch)
            shapes[name + ".weight"] = ((nfilt, in_ch, 3, 3), "fan_in")
            shapes[name + ".bias"] = ((nfilt,), "bias")
        name = "conv_feat.bn%d" % layer
        shapes[name + ".weight"] = ((nfilt,), "scale")
        shapes[name + ".bias"] = ((nfilt,), "bias")
        shapes[name + ".running_mean"] = ((nfilt,), "bias")
        shapes[name + ".running_var"] = ((nfilt,), "variance")
        shapes[name + ".num_batches_tracked"] = ((), "count")
        in_ch = nfilt
    ph, pd = cfg["caps_primary_num"], cfg["caps_primary_dim"]
    shapes["flatten.weight"] = ((ph, front_end_width(cfg) * nfilt), "fan_in")
    shapes["flatten.bias"] = ((ph,), "bias")
    for name in ("encaps1", "encaps2"):
        shapes[name + ".weight"] = ((pd, 1, 3, 3), "fan_in")
        shapes[name + ".bias"] = ((pd,), "bias")
    shapes["ln_input.weight"] = ((ph * pd,), "scale")
    shapes["ln_input.bias"] = ((ph * pd,), "bias")
    for i, (in_n, out_n, out_d, in_d) in enumerate(layer_shapes(cfg)):
        shapes["W%d" % i] = ((in_n, out_n, out_d, in_d), "routing")
        shapes["b%d" % i] = ((in_n, out_n, out_d), "routing")
        shapes["ln_mid%d.weight" % (i + 1)] = ((out_n * out_d,), "scale")
        shapes["ln_mid%d.bias" % (i + 1)] = ((out_n * out_d,), "bias")
    shapes["ln_output.weight"] = ((cfg["class_n"],), "scale")
    shapes["ln_output.bias"] = ((cfg["class_n"],), "bias")
    return shapes


def trained_names(cfg):
    """The names of the trained weights (not the BatchNorm statistics)."""
    return [name for name, (_, kind) in param_shapes(cfg).items()
            if kind not in ("variance", "count")
            and not name.endswith("running_mean")]


def same_pads(length, kernel, stride):
    """(before, after) of flax's SAME padding of one axis."""
    total = max((math.ceil(length / stride) - 1) * stride + kernel - length,
                0)
    return total // 2, total - total // 2


def length_mask(lengths, divisor, steps, device):
    """[B, steps] 1/0 mask of the frames below ceil(len / divisor)."""
    valid = torch.ceil(lengths.to(torch.float32) / divisor)
    return (torch.arange(steps, device=device)[None, :]
            < valid.to(device)[:, None]).to(torch.float32)


def squash(s):
    squared = (s * s).sum(-1, keepdim=True)
    return squared / (1.0 + squared) * (s / torch.sqrt(squared + 1e-7))


def batch_norm(x, p, name, training):
    """flax BatchNorm of NCHW ``x``: batch mean and biased variance over
    (B, H, W) in training, running statistics in eval."""
    if training:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    shape = (1, -1, 1, 1)
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + 1e-3)
            * p[name + ".weight"].reshape(shape)
            + p[name + ".bias"].reshape(shape))


def front_end(p, feats, lengths, cfg, drop, training):
    """[B, T, feat] -> primary capsules [B, T', PH, PD]."""
    x = feats[:, None]
    stride = cfg["stride"]
    for layer in range(cfg["conv_layer_num"]):
        t_pad = same_pads(x.shape[2], 3, stride)
        f_pad = same_pads(x.shape[3], 3, stride)
        x = F.pad(x, [*f_pad, *t_pad])
        branches = []
        for branch in range(2):
            name = "conv_feat.conv%d_%d" % (layer, branch)
            y = F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride)
            branches.append(drop(y, 0.2))
        x = torch.maximum(*branches)
        mask = length_mask(lengths, stride ** (layer + 1), x.shape[2],
                           x.device)[:, None, :, None]
        x = batch_norm(x * mask, p, "conv_feat.bn%d" % layer, training) * mask
    batch, steps = x.shape[0], x.shape[2]
    emb = F.linear(x.permute(0, 2, 3, 1).reshape(batch, steps, -1),
                   p["flatten.weight"], p["flatten.bias"])
    grid = emb[:, None]
    caps = torch.maximum(
        drop(F.conv2d(grid, p["encaps1.weight"], p["encaps1.bias"],
                      padding=1), 0.2),
        drop(F.conv2d(grid, p["encaps2.weight"], p["encaps2.bias"],
                      padding=1), 0.2))
    caps = caps * length_mask(lengths, subsample(cfg), steps,
                              caps.device)[:, None, :, None]
    caps = squash(caps.permute(0, 2, 3, 1))
    ph, pd = cfg["caps_primary_num"], cfg["caps_primary_dim"]
    flat = F.layer_norm(caps.reshape(batch, steps, ph * pd), (ph * pd,),
                        p["ln_input.weight"], p["ln_input.bias"], 1e-3)
    return drop(flat.reshape(batch, steps, ph, pd), cfg["inp_dropout"])


def window(u, lpad, rpad):
    """[B, T, n, d] -> [B, T, (lpad + rpad + 1) n, d]: copy i is the input
    zero-padded by (lpad, rpad) frames and shifted by i."""
    steps = u.shape[1]
    padded = F.pad(u, (0, 0, 0, 0, lpad, rpad))
    return torch.cat([padded[:, i:i + steps]
                      for i in range(lpad + rpad + 1)], dim=2)


def sdr(u, wgt, bias, iterations, pad_first):
    """Sequential dynamic routing of [B, T, in_n, in_d] -> [B, T, out_n,
    out_d], one frame at a time, the carry starting at zero. The prediction
    vectors of every frame come first, as one batched product laid out
    [T, B, out_n, in_n, out_d], so that each frame's routing is two batched
    products over (B, out_n) and the frames' slices need no copy."""
    batch, steps, in_n, in_d = u.shape
    out_n, out_d = wgt.shape[1], wgt.shape[2]
    products = torch.matmul(
        u.permute(2, 0, 1, 3).reshape(in_n, batch * steps, in_d),
        wgt.reshape(in_n, out_n * out_d, in_d).transpose(1, 2))
    u_hat = (products + bias.reshape(in_n, 1, out_n * out_d)).reshape(
        in_n, batch, steps, out_n, out_d).permute(2, 1, 3, 0, 4).contiguous()
    v = u.new_zeros(batch, out_n, out_d)
    pad = None
    if pad_first:
        pad = u.new_zeros(out_n, 1)
        pad[0] = NEG_INF
    outs = []
    for u_t in u_hat.unbind(0):
        logits = None
        for _ in range(iterations):
            agree = torch.matmul(u_t, v.unsqueeze(-1)).squeeze(-1)
            logits = agree if logits is None else logits + agree
            if pad is not None:
                logits = logits + pad
            c = torch.softmax(logits, dim=1)
            v = squash(torch.matmul(c.unsqueeze(2), u_t).squeeze(2))
        outs.append(v)
    return torch.stack(outs, dim=1)


def forward(p, feats, lengths, cfg, drop=None, training=False):
    """CTC logits [B, T', class_n] of padded ``feats`` [B, T, feat] with
    ``lengths`` [B] (host). ``drop``: the update's ``common.Dropout`` in
    training (``training``: BatchNorm on batch statistics)."""
    drop = drop or Dropout()
    emb = front_end(p, feats, lengths, cfg, drop, training)
    batch, steps = emb.shape[:2]
    shapes = layer_shapes(cfg)
    for i, (_, out_n, out_d, _) in enumerate(shapes):
        emb = sdr(window(emb, cfg["lpad"], cfg["rpad"]), p["W%d" % i],
                  p["b%d" % i], num_iter(cfg), i == len(shapes) - 1)
        flat = F.layer_norm(emb.reshape(batch, steps, out_n * out_d),
                            (out_n * out_d,), p["ln_mid%d.weight" % (i + 1)],
                            p["ln_mid%d.bias" % (i + 1)], 1e-3)
        emb = drop(flat.reshape(batch, steps, out_n, out_d),
                   cfg["inn_dropout"])
    lengths_out = torch.sqrt((emb * emb).sum(-1) + 1e-7)
    return F.layer_norm(lengths_out, (cfg["class_n"],),
                        p["ln_output.weight"], p["ln_output.bias"], 1e-3)


def _flops_kwargs(cfg):
    return dict(feat_dim=cfg["feat_dim"], enc_num=cfg["enc_num"],
                ph=cfg["caps_primary_num"], pd=cfg["caps_primary_dim"],
                ch=cfg["caps_conv_num"], cd=cfg["caps_conv_dim"],
                class_n=cfg["class_n"], vd=cfg["caps_class_dim"],
                lpad=cfg["lpad"], rpad=cfg["rpad"], num_iter=num_iter(cfg),
                conv_layer_num=cfg["conv_layer_num"],
                conv_filter_num=cfg["conv_filter_num"], stride=cfg["stride"])


def forward_flops(batch, frames, cfg):
    """Model FLOPs of one forward over ``batch`` rows of ``frames`` frames
    (``counts.flops.srf_forward_flops``)."""
    return counts.srf_forward_flops(batch, frames, **_flops_kwargs(cfg))


def train_step_flops(batch, frames, cfg):
    """Model FLOPs of one train step (``counts.flops.srf_train_step_flops``:
    3 x the forward, no recompute)."""
    return counts.srf_train_step_flops(batch, frames, **_flops_kwargs(cfg))
