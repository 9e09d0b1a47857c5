"""Length masks (port of the length-mask part of ``srf_tpu/ops/masking.py``).

Parity target (reference: tfsr/helper/model_helper.py:125-153):
:func:`feat_mask` / :func:`feat_mask2` zero padded frames after conv /
projection layers via a ``ceil(len/div)`` sequence mask.
"""

import torch


def sequence_mask(lengths, maxlen, dtype=torch.float32):
    """[B] lengths -> [B, maxlen] 1/0 mask."""
    positions = torch.arange(maxlen, device=lengths.device)[None, :]
    return (positions < lengths[:, None]).to(dtype)


def subsampled_lengths(lengths, divisor):
    """ceil(len / divisor), matching the reference's conv-subsample math."""
    return torch.ceil(lengths.to(torch.float32) / divisor).to(torch.int32)


def feat_mask(x, lengths, divisor, time_dim=1):
    """Zero padded frames of a [B, ...] tensor along ``time_dim``.

    ``time_dim=1`` is the JAX layouts [B, T, F, C] and [B, T, D]; the front
    end passes 2 for its NCHW [B, C, T, F] tensors.
    """
    mask = sequence_mask(
        subsampled_lengths(lengths, divisor), x.shape[time_dim], x.dtype
    )
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[time_dim] = x.shape[time_dim]
    return x * mask.reshape(shape)


# the 3-D [B, T, D] mask, under the JAX package's name
feat_mask2 = feat_mask
