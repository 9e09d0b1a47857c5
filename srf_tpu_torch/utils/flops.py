"""Analytic FLOP accounting for MFU / roofline reporting (the port's copy
of ``srf_tpu/utils/flops.py``, with the H100's peaks).

The SRF's time recurrence runs a loop of small steps, so its work is
counted from the model's shapes rather than read off a profiler.
Conventions:

- 1 MAC = 2 FLOPs.
- ``train_flops = 3 x forward`` (backward costs ~2x forward for matmul
  grads); rematerialized recompute is NOT counted — MFU measures useful
  model FLOPs, recompute is overhead the utilization number should punish.
- MFU denominator: the peak of the dtype the step computes in, dense, of
  the SXM5 H100 80GB (NVIDIA's data sheet, 700 W): bf16 on the tensor
  cores 989.4e12 FLOP/s, float32 outside them 66.9e12 (the port's float32
  steps run with TF32 off, F8), HBM3 3.35e12 B/s. A card capped below 700
  W runs slower under load, so a reading names the card and its limit.

Reference shapes: the SRF capsule stack (reference:
tfsr/model/sequence_router_naive.py:88-95) and CNN front-end
(sequence_router.py:44-82).
"""

import math

H100_PEAK_BF16 = 989.4e12
H100_PEAK_FP32 = 66.9e12
H100_HBM_BPS = 3.35e12


def conv2d_flops(batch, out_h, out_w, out_c, k_h, k_w, in_c):
    return 2.0 * batch * out_h * out_w * out_c * k_h * k_w * in_c


def srf_forward_flops(batch, frames, feat_dim, enc_num, ph, pd, ch, cd,
                      class_n, vd, lpad, rpad, num_iter,
                      conv_layer_num=2, conv_filter_num=64, stride=2):
    """Forward FLOPs of one SequenceRouter call on a padded batch.

    Counts the conv front-end, capsulation, every routing layer's
    prediction einsum and routing iterations. Elementwise epilogues
    (squash, LN, dropout) are counted with a small constant per element.
    """
    window = lpad + rpad + 1
    total = 0.0
    # conv front-end: two parallel convs per layer, maxout join
    t, f, in_c = frames, feat_dim, 1
    for _ in range(conv_layer_num):
        t = math.ceil(t / stride)
        f = math.ceil(f / stride)
        total += 2 * conv2d_flops(batch, t, f, conv_filter_num, 3, 3, in_c)
        in_c = conv_filter_num
    t_sub = t
    # flatten Dense -> PH
    total += 2.0 * batch * t_sub * (f * conv_filter_num) * ph
    # encaps: two parallel 3x3 convs (in_c=1 -> PD) on the [T', PH] grid
    total += 2 * conv2d_flops(batch, t_sub, ph, pd, 3, 3, 1)

    # capsule layers
    shapes = []
    if enc_num == 1:
        shapes.append((ph * window, class_n, vd, pd))
    else:
        shapes.append((ph * window, ch, cd, pd))
        for _ in range(1, enc_num - 1):
            shapes.append((ch * window, ch, cd, cd))
        shapes.append((ch * window, class_n, vd, cd))
    for in_n, out_n, out_d, in_d in shapes:
        # u_hat = W.u + b for every timestep
        total += 2.0 * batch * t_sub * in_n * out_n * out_d * in_d
        # per routing iteration: agreement logits + weighted sum
        total += num_iter * 2 * (2.0 * batch * t_sub * in_n * out_n * out_d)
        # squash + LN epilogue (~8 flops/elem)
        total += 8.0 * batch * t_sub * out_n * out_d
    return total


def srf_train_step_flops(batch, frames, **kw):
    """Model FLOPs of one train step (fwd + bwd, no remat recompute)."""
    return 3.0 * srf_forward_flops(batch, frames, **kw)


def _frontend_flops(batch, frames, feat_dim, cnn_n=2, nfilt=64, stride=2):
    """ConvFrontEnd: per layer two parallel Conv2D(nfilt,3x3,stride 2) joined
    by maxout (reference CapsulationLayer, tfsr/model/sequence_router.py:44-82).
    Returns (flops, t_sub, f_sub)."""
    total, t, f, in_c = 0.0, frames, feat_dim, 1
    for _ in range(cnn_n):
        t = math.ceil(t / stride)
        f = math.ceil(f / stride)
        total += 2 * conv2d_flops(batch, t, f, nfilt, 3, 3, in_c)
        in_c = nfilt
    return total, t, f


def stf_forward_flops(batch, frames, feat_dim, num_layers, d_model,
                      num_heads, dff, vocab_n, cnn_n=2, nfilt=64, stride=2):
    """Forward FLOPs of the STF ConvEncoder (reference: trainer_tf.py:39-118).

    Front-end + Dense(d_model) + N x (QKV/out projections, QK^T and AV
    attention matmuls, FFN) + Dense(vocab)."""
    total, t, f = _frontend_flops(batch, frames, feat_dim, cnn_n, nfilt, stride)
    total += 2.0 * batch * t * (f * nfilt) * d_model  # linear_projection
    per_layer = (
        4 * 2.0 * batch * t * d_model * d_model      # Q,K,V,out projections
        + 2 * 2.0 * batch * t * t * d_model          # QK^T + AV (all heads)
        + 2 * 2.0 * batch * t * d_model * dff        # FFN two matmuls
    )
    total += num_layers * per_layer
    total += 2.0 * batch * t * d_model * vocab_n     # output Dense
    # LN/softmax/dropout epilogues ~10 flops/elem
    total += num_layers * 10.0 * batch * t * (2 * d_model + dff)
    return total


def lstm_forward_flops(batch, frames, feat_dim, num_layers, d_model,
                       vocab_n, bidirectional=True, is_cnnfe=True,
                       cnn_n=2, nfilt=64, stride=2):
    """Forward FLOPs of the (B)LSTM encoder (reference: lstm_encoder.py:31-103).

    Per direction per layer: input + recurrent matmuls of the 4 gates,
    2*T*4*h*(in+h) MACs, plus ~12 flops/elem of gate nonlinearities."""
    total, t, in_dim = 0.0, frames, feat_dim
    if is_cnnfe:
        fe, t, f = _frontend_flops(batch, frames, feat_dim, cnn_n, nfilt, stride)
        total += fe
        in_dim = f * nfilt
    ndir = 2 if bidirectional else 1
    h = d_model
    for _ in range(num_layers):
        total += ndir * 2.0 * batch * t * 4 * h * (in_dim + h)
        total += ndir * 12.0 * batch * t * h
        in_dim = h  # 'ave' merge keeps width h
    total += 2.0 * batch * t * h * vocab_n
    return total


def _maxout_conv_body_flops(batch, t, f, in_c, layer_filters,
                            pool_after_first, proj_layers, proj_dim,
                            flat_dim, class_n):
    """Shared maxout conv + projection body (models/cnn.py:_MaxoutConvStack;
    reference cnn_encoder.py:34-182). ``layer_filters`` is the per-layer
    (filters, time_stride) list; maxout halves channels after each conv."""
    total = 0.0
    for idx, (filters, t_stride) in enumerate(layer_filters):
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
    """CNNEncoder maxpool variant (models/cnn.py:CNNEncoder)."""
    pooled_dim = feat_dim // 3
    last_filt = (proj_dim // pooled_dim) * 2
    layer_filters = (
        [(nfilt_inp, stride)] * conv_layer_num
        + [(nfilt_inp, 1)] * (4 - conv_layer_num)
        + [(nfilt_inn, 1)] * (enc_num - 5)
        + [(last_filt, 1)]
    )
    return _maxout_conv_body_flops(
        batch, frames, feat_dim, 1, layer_filters, True,
        proj_layers, proj_dim, pooled_dim * (last_filt // 2), class_n,
    )


def cnn_stride_forward_flops(batch, frames, feat_dim, enc_num, class_n,
                             nfilt_inp, nfilt_inn, proj_layers, proj_dim,
                             conv_layer_num=2, conv_filter_num=64):
    """CNNStrideEncoder (models/cnn.py:CNNStrideEncoder): ConvFrontEnd +
    stride-1 maxout body."""
    fe, t, f = _frontend_flops(
        batch, frames, feat_dim, conv_layer_num, conv_filter_num, 2
    )
    fe_dim = math.ceil(feat_dim / (2**conv_layer_num))
    last_filt = (proj_dim // fe_dim) * 2
    layer_filters = (
        [(nfilt_inp, 1)] * 4
        + [(nfilt_inn, 1)] * (enc_num - 5)
        + [(last_filt, 1)]
    )
    return fe + _maxout_conv_body_flops(
        batch, t, f, conv_filter_num, layer_filters, False,
        proj_layers, proj_dim, fe_dim * (last_filt // 2), class_n,
    )


def mfu(flops_per_step, step_seconds, peak):
    """Model FLOPs per second over ``peak``, the peak of the dtype the
    step computes in (``H100_PEAK_FP32`` or ``H100_PEAK_BF16``)."""
    return flops_per_step / step_seconds / peak
