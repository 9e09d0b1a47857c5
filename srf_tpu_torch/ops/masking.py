"""Length masks and attention biases (port of ``srf_tpu/ops/masking.py``).

Parity targets (reference: tfsr/helper/model_helper.py):
- :func:`feat_mask` / :func:`feat_mask2` zero padded frames after conv /
  projection layers via a ``ceil(len/div)`` sequence mask
  (model_helper.py:125-153),
- :func:`get_padding_bias` builds the [B,1,1,T'] attention bias that is 1
  at padding (model_helper.py:79-98),
- look-ahead / combined masks for the decoder blocks (model_helper.py:
  101-122).
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


def get_padding_bias(inp_len, maxlen, strides=4, dtype=torch.float32):
    """[B,1,1,T'] tensor: 0 at valid frames, 1 at padding (multiplied by
    -1e9 inside attention; reference: model_helper.py:79-98)."""
    mask = sequence_mask(subsampled_lengths(inp_len, strides), maxlen, dtype)
    return (1.0 - mask)[:, None, None, :]


def create_padding_mask(seq, dtype=torch.float32):
    """[B,1,1,L] mask: 1 where token id == 0 (padding)."""
    return (seq == 0).to(dtype)[:, None, None, :]


def create_look_ahead_mask(size, dtype=torch.float32, device=None):
    """[L,L] upper-triangular mask of future positions."""
    return 1.0 - torch.tril(torch.ones(size, size, dtype=dtype,
                                       device=device))


def create_combined_mask(tar):
    """max(padding mask, look-ahead mask) of [B, L] token ids: [B,1,L,L]."""
    look_ahead = create_look_ahead_mask(tar.shape[1], device=tar.device)
    return torch.maximum(create_padding_mask(tar), look_ahead)
