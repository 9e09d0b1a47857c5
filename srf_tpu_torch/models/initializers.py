"""Weight initializers (port of ``srf_tpu/models/initializers.py``).

Reference: tfsr/helper/model_helper.py:156-164 — ``fan_avg`` is
VarianceScaling(1.0, fan_avg, uniform), ``uniform`` is RandomUniform(±0.05),
anything else falls back to glorot_uniform. VarianceScaling(1, fan_avg,
uniform) draws from U(±sqrt(6 / (fan_in + fan_out))), which is glorot
uniform, so both map to ``xavier_uniform_``; torch's fan computation on the
OIHW / [out, in] layouts gives the same fans as flax's on HWIO / [in, out].
Randomness flows from an explicit ``torch.Generator``.
"""

import torch

from srf_tpu_torch.config.constants import Constants


def get_init(init_name):
    """Returns ``init(tensor, generator)`` filling ``tensor`` in place."""
    if init_name == Constants.INIT_UNIFORM:
        return lambda t, gen: torch.nn.init.uniform_(t, -0.05, 0.05, generator=gen)
    return lambda t, gen: torch.nn.init.xavier_uniform_(t, generator=gen)


def routing_weight_init(stddev=0.1):
    """Routing transformation matrices and biases: normal(0, 0.1)
    (reference: sequence_router_naive.py:97-103)."""
    return lambda t, gen: torch.nn.init.normal_(t, 0.0, stddev, generator=gen)


def lecun_normal():
    """flax's default Dense kernel init, ``variance_scaling(1, fan_in,
    truncated_normal)``: a normal truncated at +-2 std whose std is
    ``sqrt(1 / fan_in) / 0.8796...`` (the truncation's correction), for a
    torch [out, in] weight."""

    def init(t, gen):
        std = (1.0 / t.shape[1]) ** 0.5 / 0.87962566103423978
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                           generator=gen)

    return init
