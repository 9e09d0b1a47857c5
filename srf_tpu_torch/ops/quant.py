"""Post-training int8 weight quantization for serving (port of
``srf_tpu/ops/quant.py``, ``--tpu-serve-quant=int8``).

Scheme, as JAX's: symmetric per-output-channel int8, weight only. A leaf
of the flax parameter tree is quantized when it is float32, has at least 2
dimensions and at least ``MIN_SIZE`` elements; its channel is the flax
layout's last axis: scale[c] = max|w[..., c]| / 127 and q = round(w /
scale) clipped to [-127, 127].

The port's modules keep torch layouts, so each channel maps to the torch
dimension that holds flax's last axis (``convert.py`` gives the layouts):

- Linear weight [out, in] (Dense [in, out]): dim 0;
- Conv2d weight OIHW (Conv HWIO): dim 0;
- routing W{i} [in_n, out_n, out_d, in_d] and b{i} [in_n, out_n, out_d],
  kept in JAX's layout: their last dim (in_d and out_d);
- nn.LSTM's weight_ih/weight_hh [4H, in] (flax: one [in, H] kernel per
  gate): dim 0, each gate's block counted apart for the size rule.

1-D tensors (biases, norms) and BatchNorm statistics stay float32.

``quantize_model`` replaces each quantized parameter by a parametrization
(``torch.nn.utils.parametrize``) that holds only the int8 tensor and its
scales: reading the weight dequantizes it into a temporary, inside the
forward, so no float32 copy of a quantized weight stays among the module's
parameters and buffers. (``nn.LSTM`` keeps references to the weights of
its last forward for cuDNN, until the next one.)
"""

import torch
from torch import nn
from torch.nn.utils import parametrize

MIN_SIZE = 4096
_LSTM_WEIGHTS = ("weight_ih_l", "weight_hh_l")


def _flax_leaf(name, tensor):
    """(torch dim of the flax leaf's last axis, the flax leaf's element
    count) for a state_dict entry, or None where flax has no such leaf of
    >= 2 dims."""
    leaf = name.rsplit(".", 1)[-1]
    if tensor.dim() < 2:
        return None
    if "." not in name:  # routing W{i} / b{i}: JAX's layout
        return tensor.dim() - 1, tensor.numel()
    if leaf.startswith(_LSTM_WEIGHTS):
        return 0, tensor.numel() // 4  # four gate kernels [in, H]
    if leaf == "weight" and tensor.dim() in (2, 4):
        return 0, tensor.numel()
    return None


def quantize_dims(model, min_size=MIN_SIZE):
    """{parameter name: torch dim of its channels} for the parameters JAX's
    ``quantize_tree`` quantizes."""
    dims = {}
    for name, param in model.named_parameters():
        found = _flax_leaf(name, param)
        if (found is not None and param.dtype == torch.float32
                and found[1] >= min_size):
            dims[name] = found[0]
    return dims


def quantize_tensor(weight, dim):
    """float32 ``weight`` -> (q int8, scale float32 with ``weight``'s rank,
    1 everywhere but ``dim``): q * scale ~ weight."""
    others = tuple(d for d in range(weight.dim()) if d != dim)
    absmax = weight.abs().amax(dim=others, keepdim=True)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(weight / scale), -127, 127).to(torch.int8)
    return q, scale


class Int8Weight(nn.Module):
    """The parametrization of a quantized weight: stores (q, scale), and
    reads as q * scale in float32."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, q, scale):
        return q.to(torch.float32) * scale

    def right_inverse(self, weight):
        return quantize_tensor(weight.detach(), self.dim)


def quantize_model(model, min_size=MIN_SIZE):
    """Quantize ``model``'s weights in place (see the module docstring);
    returns the {name: channel dim} it quantized. Serving only: the int8
    originals take no gradient."""
    dims = quantize_dims(model, min_size)
    for name, dim in dims.items():
        *path, leaf = name.split(".")
        module = model.get_submodule(".".join(path))
        getattr(module, leaf).requires_grad_(False)
        parametrize.register_parametrization(module, leaf, Int8Weight(dim),
                                             unsafe=True)
        if isinstance(module, nn.RNNBase):
            module._init_flat_weights()  # drop its float32 references
    return dims


def quantized_leaves(model):
    """{parameter name: (q, scale)} of a quantized model, in torch layout
    (scale has q's rank, 1 everywhere but the channel dim)."""
    out = {}
    for module_name, module in model.named_modules():
        if not parametrize.is_parametrized(module):
            continue
        for leaf, plist in module.parametrizations.items():
            name = (module_name + "." if module_name else "") + leaf
            out[name] = (plist.original0, plist.original1)
    return out


def quantized_bytes(model):
    """(resident bytes of the quantized model's parameters, bytes of the
    same in float32), over the leaves JAX's parameter tree has (nn.LSTM's
    second bias, a zero torch keeps, is not one): JAX's
    ``quantized_bytes``."""
    q_bytes = f_bytes = 0
    leaves = quantized_leaves(model)
    for q, scale in leaves.values():
        q_bytes += q.numel() + scale.numel() * 4
        f_bytes += q.numel() * 4
    for name, param in model.named_parameters():
        if "parametrizations." in name or ".bias_ih_l" in name:
            continue
        q_bytes += param.numel() * param.element_size()
        f_bytes += param.numel() * param.element_size()
    return q_bytes, f_bytes
