"""Capsule nonlinearities (port of ``srf_tpu/ops/squash.py``).

Exact math of the reference (reference: tfsr/model/sequence_router.py:29-41):
    squash(s) = (|s|^2 / (1 + |s|^2)) * s / sqrt(|s|^2 + eps),  eps = 1e-7
    length(s) = sqrt(sum(s^2) + eps)
"""

import torch


def squash(s, dim=-1, epsilon=1e-7):
    squared_norm = torch.sum(s * s, dim=dim, keepdim=True)
    safe_norm = torch.sqrt(squared_norm + epsilon)
    squash_factor = squared_norm / (1.0 + squared_norm)
    return squash_factor * (s / safe_norm)


def capsule_length(s, dim=-1, epsilon=1e-7, keepdim=False):
    squared_norm = torch.sum(s * s, dim=dim, keepdim=keepdim)
    return torch.sqrt(squared_norm + epsilon)
