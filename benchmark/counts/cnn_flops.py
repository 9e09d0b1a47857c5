"""Frozen copy of the maxout CNN's counts in ``srf_tpu_torch/utils/flops.py``
(``_maxout_conv_body_flops``, ``cnn_maxpool_forward_flops``), and the
least time the card could take for the convolutions and for K5 (the fused
dropout, ``csrc/fused_dropout.cu``) of one train step, from its shapes
alone.

The benchmark reads these and never the program's, so that a change to the
program cannot move the yardstick. ``layers`` lists the maxpool variant's
convolutions as the recipe builds them; ``dropout_sites`` its dropout
sites, in the order a forward runs them. A bound is the larger of the
call's bytes over the HBM bandwidth and its float32 operations over the
float32 peak (``flops.H100_HBM_BPS``, ``flops.H100_PEAK_FP32``), each input
byte counted as read once and each output byte as written once.
"""

import math

from benchmark.counts.flops import H100_HBM_BPS, H100_PEAK_FP32, conv2d_flops


def layer_filters(feat_dim, enc_num, nfilt_inp, nfilt_inn, proj_dim,
                  conv_layer_num=2, stride=2):
    """[(filters, time stride)] of the maxpool variant's convolutions, and
    (pooled feature width, the last convolution's filters)."""
    pooled_dim = feat_dim // 3
    last_filt = (proj_dim // pooled_dim) * 2
    filters = ([(nfilt_inp, stride)] * conv_layer_num
               + [(nfilt_inp, 1)] * (4 - conv_layer_num)
               + [(nfilt_inn, 1)] * (enc_num - 5)
               + [(last_filt, 1)])
    return filters, pooled_dim, last_filt


def _maxout_conv_body_flops(batch, t, f, in_c, layer_filters_,
                            pool_after_first, proj_layers, proj_dim,
                            flat_dim, class_n):
    """Shared maxout conv + projection body (``layer_filters_`` the
    per-layer (filters, time_stride) list; maxout halves channels after
    each conv)."""
    total = 0.0
    for idx, (filters, t_stride) in enumerate(layer_filters_):
        t = math.ceil(t / t_stride)
        total += conv2d_flops(batch, t, f, filters, 5, 3, in_c)
        in_c = filters // 2
        if pool_after_first and idx == 0:
            f = f // 3
        total += 10.0 * batch * t * f * in_c  # LN/dropout epilogue
    in_dim = flat_dim
    for _ in range(proj_layers - 1):
        total += 2.0 * batch * t * in_dim * proj_dim
        in_dim = proj_dim // 2
        total += 10.0 * batch * t * in_dim
    total += 2.0 * batch * t * in_dim * (class_n * 2)
    return total


def cnn_maxpool_forward_flops(batch, frames, feat_dim, enc_num, class_n,
                              nfilt_inp, nfilt_inn, proj_layers, proj_dim,
                              conv_layer_num=2, stride=2):
    """Forward FLOPs of the maxpool variant on a padded batch."""
    filters, pooled_dim, last_filt = layer_filters(
        feat_dim, enc_num, nfilt_inp, nfilt_inn, proj_dim, conv_layer_num,
        stride)
    return _maxout_conv_body_flops(
        batch, frames, feat_dim, 1, filters, True, proj_layers, proj_dim,
        pooled_dim * (last_filt // 2), class_n)


def conv_calls(batch, frames, feat_dim, enc_num, nfilt_inp, nfilt_inn,
               proj_dim, conv_layer_num=2, stride=2):
    """[(direction, bytes, operations)] of every convolution call of one
    train step on a padded [batch, frames] input: each layer's forward,
    its data gradient (not the first layer's: the features take none) and
    its weight gradient. A (5, 3) kernel with SAME padding keeps the
    frequency width and divides time by the stride."""
    filters, _, _ = layer_filters(feat_dim, enc_num, nfilt_inp, nfilt_inn,
                                  proj_dim, conv_layer_num, stride)
    calls, t, f, in_c = [], frames, feat_dim, 1
    for idx, (out_c, t_stride) in enumerate(filters):
        t_out = math.ceil(t / t_stride)
        ops = conv2d_flops(batch, t_out, f, out_c, 5, 3, in_c)
        x, w, y = batch * t * f * in_c, out_c * in_c * 15, \
            batch * t_out * f * out_c
        calls.append(("fwd", 4 * (x + w + y), ops))
        if idx:
            calls.append(("dgrad", 4 * (y + w + x), ops))
        calls.append(("wgrad", 4 * (x + y + w), ops))
        t, in_c = t_out, out_c // 2
        if idx == 0:
            f //= 3
    return calls


def dropout_sites(batch, frames, feat_dim, enc_num, class_n, nfilt_inp,
                  nfilt_inn, proj_layers, proj_dim, conv_layer_num=2,
                  stride=2):
    """Elements of each dropout site of one forward, in order: after each
    convolution (its output) and after its LayerNorm (the maxed, pooled
    width); after each projection and its LayerNorm; after ``projv``."""
    filters, _, _ = layer_filters(feat_dim, enc_num, nfilt_inp, nfilt_inn,
                                  proj_dim, conv_layer_num, stride)
    sizes, t, f = [], frames, feat_dim
    for idx, (out_c, t_stride) in enumerate(filters):
        t = math.ceil(t / t_stride)
        sizes.append(batch * t * f * out_c)
        if idx == 0:
            f //= 3
        sizes.append(batch * t * f * (out_c // 2))
    for _ in range(proj_layers - 1):
        sizes += [batch * t * proj_dim, batch * t * (proj_dim // 2)]
    sizes.append(batch * t * class_n * 2)
    return sizes


def bound_s(nbytes, ops):
    """Seconds the card needs at least for a call's bytes and operations."""
    return max(nbytes / H100_HBM_BPS, ops / H100_PEAK_FP32)
