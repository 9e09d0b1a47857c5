"""Model building blocks (port of the SRF part of ``srf_tpu/models/layers.py``).

:class:`ConvFrontEnd` — the reference's "CapsulationLayer" CNN front-end:
per layer two parallel stride-2 3x3 convs combined by maxout, each with
dropout 0.2, then length-mask -> BatchNorm -> length-mask
(reference: tfsr/model/sequence_router.py:44-82). Eval form only: BatchNorm
normalises with its running statistics (eps 1e-3).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from srf_tpu_torch.ops.masking import feat_mask


def same_pad(x, kernel_size, stride):
    """Pad the last two axes of NCHW ``x`` as flax/TF ``padding="SAME"`` does.

    SAME pads ``max((ceil(L/s)-1)*s + k - L, 0)`` in all, the odd one at
    the end: with k=3, s=2 that is (0, 1) on an even axis and (1, 1) on an
    odd one, where torch's ``padding=1`` would always pad (1, 1) and sample
    a shifted grid.
    """
    pads = []
    for length in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((math.ceil(length / stride) - 1) * stride + kernel_size
                    - length, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvFrontEnd(nn.Module):
    """Maxout conv subsampler; [B, T, F] -> [B, ceil(T/s^n), F', nfilt]."""

    def __init__(self, cnn_n, nfilt, kernel_size=3, stride=2):
        super().__init__()
        self.cnn_n = cnn_n
        self.kernel_size = kernel_size
        self.stride = stride
        in_ch = 1
        for conv_idx in range(cnn_n):
            for branch in range(2):
                setattr(self, "conv%d_%d" % (conv_idx, branch),
                        nn.Conv2d(in_ch, nfilt, kernel_size, stride))
            setattr(self, "bn%d" % conv_idx, nn.BatchNorm2d(nfilt, eps=1e-3))
            in_ch = nfilt
        self.dropout = nn.Dropout(0.2)

    def forward(self, inputs, input_lengths):
        x = inputs[:, None]  # NCHW [B, 1, T, F]
        for conv_idx in range(self.cnn_n):
            x = same_pad(x, self.kernel_size, self.stride)
            x = torch.maximum(
                self.dropout(getattr(self, "conv%d_0" % conv_idx)(x)),
                self.dropout(getattr(self, "conv%d_1" % conv_idx)(x)),
            )
            divisor = self.stride ** (conv_idx + 1)
            x = feat_mask(x, input_lengths, divisor, time_dim=2)
            x = getattr(self, "bn%d" % conv_idx)(x)
            x = feat_mask(x, input_lengths, divisor, time_dim=2)
        return x.permute(0, 2, 3, 1)  # the JAX layout [B, T', F', C]
