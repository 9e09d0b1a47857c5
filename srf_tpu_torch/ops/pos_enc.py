"""Sinusoidal positional encoding (port of ``srf_tpu/ops/pos_enc.py``).

Same formulation as the reference (reference: tfsr/helper/model_helper.py:
30-58, the official-transformer layout: [sin(all timescales) ||
cos(all timescales)], not interleaved). Computed in float32.
"""

import math

import torch


def get_pos_enc(length, hidden_size, min_timescale=1.0, max_timescale=1.0e4,
                device=None):
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = hidden_size // 2
    log_timescale_increment = math.log(float(max_timescale) / float(min_timescale)) / (
        float(num_timescales) - 1
    )
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_timescale_increment
    )
    scaled_time = position[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)], dim=1)
