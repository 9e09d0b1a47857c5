"""Seeded weights and statistics of a configuration, made on the device in
two large draws (one normal, one uniform) and cut into leaves, by the
shapes and kinds of its family's ``param_shapes``.

Both sides take these: the program loads them by name, the reference uses
them as they are. Convolution and dense weights are normal over
sqrt(fan_in); biases, routing weights and BatchNorm means normal(0, 0.1);
norm scales 1 + normal(0, 0.1); BatchNorm variances uniform in [0.5, 1.5).
"""

import math

import torch

_SCALE = {"bias": 0.1, "routing": 0.1, "scale": 0.1}


def make(shapes, seed, device):
    """{name: float32 tensor on ``device``} for ``shapes`` ({name: (shape,
    kind)}, a family's ``param_shapes``), drawn from ``seed``."""
    gen = torch.Generator(device).manual_seed(seed % (1 << 63))
    normal_n = sum(math.prod(shape) for shape, kind in shapes.values()
                   if kind not in ("variance", "count"))
    uniform_n = sum(math.prod(shape) for shape, kind in shapes.values()
                    if kind == "variance")
    normal = torch.randn(normal_n, generator=gen, device=device)
    uniform = torch.rand(uniform_n, generator=gen, device=device)
    out, at_n, at_u = {}, 0, 0
    for name, (shape, kind) in shapes.items():
        size = math.prod(shape)
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if kind == "variance":
            out[name] = (0.5 + uniform[at_u:at_u + size]).reshape(shape)
            at_u += size
            continue
        leaf = normal[at_n:at_n + size].reshape(shape)
        at_n += size
        if kind == "fan_in":
            leaf = leaf / math.sqrt(math.prod(shape[1:]))
        elif kind == "scale":
            leaf = 1.0 + _SCALE[kind] * leaf
        else:
            leaf = _SCALE[kind] * leaf
        out[name] = leaf.contiguous()
    return out
