"""Frozen copy of ``srf_tpu_torch/utils/flops.py`` (the port's analytic FLOP
accounting and the H100's published peaks) as the benchmark's yardstick.

The benchmark reads its operation counts and peaks from here and never from
the program, so that a change to the program cannot move the yardstick.
Each family's counts sit here, reached through its reference's
``forward_flops`` and ``train_step_flops`` (SRF's alone so far).
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


