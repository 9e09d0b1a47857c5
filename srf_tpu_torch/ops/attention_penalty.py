"""Speech-Transformer attention distance penalty (port of
``srf_tpu/ops/attention_penalty.py``).

The reference precomputes a [num_head, 2500, 2500] "penalty board" by
accumulating band-part complements: position pairs with distance d collect
one unit of penalty for every stripe width i in
``range(zero_width - 1, max_len, stripe_width)`` with ``d > i``, scaled by
``scale`` (reference: tfsr/helper/model_helper.py:189-264; applied inside
attention as ``scores += -log(1 + penalty)``, tfsr/model/attention.py:79-80).

That count has the closed form ``ceil((d - zero_width + 1) / stripe_width)``
clipped at 0 (and bounded by the number of stripes), computed here in numpy
for any length. The penalty is identical across heads, so a broadcastable
[1, L, L] float32 tensor is returned, on the caller's device; each (length,
device) is built once and kept, as JAX bakes it into each compiled bucket.
"""

import numpy as np
import torch

MAX_LEN = 2500


class AttentionPenalty:
    def __init__(self, max_len, num_head, zero_width, stripe_width, scale):
        self.max_len = max_len
        self.num_head = num_head
        self.zero_width = zero_width
        self.stripe_width = stripe_width
        self.scale = scale
        # number of stripes the reference accumulates
        self.n_stripes = len(range(zero_width - 1, max_len, stripe_width))
        self._boards = {}

    def penalty(self, length, device=None):
        """[1, L, L] penalty values for sequences of ``length``."""
        key = (int(length), torch.device(device or "cpu"))
        if key not in self._boards:
            d = np.abs(np.arange(length)[:, None] - np.arange(length)[None, :])
            count = np.ceil((d - self.zero_width + 1) / self.stripe_width)
            count = np.clip(count, 0, self.n_stripes)
            board = (count * self.scale)[None].astype(np.float32)
            self._boards[key] = torch.from_numpy(board).to(key[1])
        return self._boards[key]

    def create_eap(self, max_frames, device=None):
        return self.penalty(int(max_frames), device)


def penalty_enabled(config):
    """The reference's gate (model_helper.py:189-216): any of the three ap
    flags, and positive widths and scale."""
    return bool(
        (config.model_ap_encoder or config.model_ap_decoder
         or config.model_ap_encdec)
        and config.model_ap_width_zero and config.model_ap_width_zero > 0
        and config.model_ap_width_stripe and config.model_ap_width_stripe > 0
        and config.model_ap_scale and config.model_ap_scale > 0.0
    )


def create_attention_penalty(config, logger):
    """Build the penalty helper when configured, else None."""
    if not penalty_enabled(config):
        logger.info("Attention penalties will not be applied.")
        return None
    logger.info(
        "Attention penalty: zero width %d, stripe width %d, scale %f",
        config.model_ap_width_zero, config.model_ap_width_stripe,
        config.model_ap_scale,
    )
    return AttentionPenalty(
        max_len=MAX_LEN,
        num_head=config.model_att_head_num,
        zero_width=config.model_ap_width_zero,
        stripe_width=config.model_ap_width_stripe,
        scale=config.model_ap_scale,
    )
