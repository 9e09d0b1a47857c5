"""SpecAugment (Park et al., 2019): time and frequency masking of the
feature batch in the train step (port of ``srf_tpu/ops/specaugment.py``;
``--tpu-specaug``, off by default, training mode only).

The work is split in two:

- :func:`draw_masks` draws, per utterance, ``time_masks`` time masks and
  ``freq_masks`` frequency masks with JAX's caps: a time mask zeroes
  ``t = randint(0, 1e6) % (cap + 1)`` frames, ``cap = min(time_width,
  int(0.2 * len))`` (the paper's p = 0.2), from ``t0 = randint(0, 1e6) %
  max(len - t + 1, 1)``; a frequency mask zeroes ``f ~ U[0, fcap]``
  feature dims, ``fcap = min(freq_width, max(F // 2, 1))``, from ``f0 =
  randint(0, 1e6) % max(F - f + 1, 1)``. The draws come from the step's
  ``torch.Generator`` on the features' device, with the lengths already
  there, so nothing is read back to the host. They are the port's own
  stream (F6 in ROADMAP.md): JAX's ``fold_in`` keys cannot be reproduced.
- :func:`apply_masks` zeroes them in the valid frames and leaves the
  padding exactly as it was (``srf_tpu/ops/specaugment.py:73-76``); given
  the same masks it equals JAX's ``spec_augment`` bit for bit.

Time warping is omitted, as in JAX.
"""

import torch


def draw_masks(inp_len, feat_dim, generator=None, time_masks=2,
               time_width=40, freq_masks=2, freq_width=15):
    """Per-utterance masks for ``inp_len`` [B] (int, on the features'
    device) and ``feat_dim`` feature dims: a dict of int64 [masks, B]
    tensors ``time_start``, ``time_width``, ``freq_start`` and
    ``freq_width``, drawn from ``generator`` (the global RNG if None)."""
    lens = inp_len.long()
    batch, device = lens.shape[0], lens.device

    def draw(high):
        return torch.randint(0, high, (batch,), generator=generator,
                             device=device)

    cap = torch.clamp((lens.float() * 0.2).long(), max=time_width)
    t_start, t_width = [], []
    for _ in range(time_masks):
        width = draw(1_000_000) % (cap + 1)
        t_width.append(width)
        t_start.append(draw(1_000_000) % torch.clamp(lens - width + 1, min=1))
    fcap = min(freq_width, max(feat_dim // 2, 1))
    f_start, f_width = [], []
    for _ in range(freq_masks):
        width = draw(fcap + 1)
        f_width.append(width)
        f_start.append(draw(1_000_000) % torch.clamp(feat_dim - width + 1,
                                                     min=1))

    def stack(rows):
        return (torch.stack(rows) if rows
                else torch.zeros((0, batch), dtype=torch.long, device=device))

    return {"time_start": stack(t_start), "time_width": stack(t_width),
            "freq_start": stack(f_start), "freq_width": stack(f_width)}


def apply_masks(feats, inp_len, masks):
    """feats [B, T, F] with ``masks`` (:func:`draw_masks`' dict, or JAX's
    draws in its layout) zeroed in the valid frames ``t < inp_len``; the
    padding passes through untouched."""
    batch, seq_len, feat_dim = feats.shape
    device = feats.device
    lens = inp_len.to(device).long()
    t_idx = torch.arange(seq_len, device=device)[None, :]
    f_idx = torch.arange(feat_dim, device=device)[None, :]
    keep = torch.ones((batch, seq_len, 1), dtype=feats.dtype, device=device)
    for start, width in zip(masks["time_start"], masks["time_width"]):
        start, width = start.to(device)[:, None], width.to(device)[:, None]
        hit = (t_idx >= start) & (t_idx < start + width)
        keep = keep * torch.where(hit[..., None], 0.0, 1.0).to(feats.dtype)
    fkeep = torch.ones((batch, 1, feat_dim), dtype=feats.dtype, device=device)
    for start, width in zip(masks["freq_start"], masks["freq_width"]):
        start, width = start.to(device)[:, None], width.to(device)[:, None]
        hit = (f_idx >= start) & (f_idx < start + width)
        fkeep = fkeep * torch.where(hit[:, None, :], 0.0, 1.0).to(
            feats.dtype)
    valid = (t_idx < lens[:, None])[..., None]
    return torch.where(valid, feats * keep * fkeep, feats)


def spec_augment(feats, inp_len, generator=None, time_masks=2, time_width=40,
                 freq_masks=2, freq_width=15):
    """feats [B, T, F], inp_len [B] -> masked feats (zero fill), the masks
    drawn from ``generator``."""
    masks = draw_masks(inp_len.to(feats.device), feats.shape[2], generator,
                       time_masks, time_width, freq_masks, freq_width)
    return apply_masks(feats, inp_len, masks)


def make_augment_fn(config):
    """``augment_fn(feats, inp_len, generator)`` from the ``--tpu-specaug*``
    flags, or None when ``--tpu-specaug`` is off."""
    if not getattr(config, "tpu_specaug", False):
        return None
    kwargs = dict(
        time_masks=getattr(config, "tpu_specaug_time_masks", 2),
        time_width=getattr(config, "tpu_specaug_time_width", 40),
        freq_masks=getattr(config, "tpu_specaug_freq_masks", 2),
        freq_width=getattr(config, "tpu_specaug_freq_width", 15),
    )

    def augment(feats, inp_len, generator=None):
        return spec_augment(feats, inp_len, generator, **kwargs)

    return augment
