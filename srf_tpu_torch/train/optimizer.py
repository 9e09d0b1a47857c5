"""Optimizer and LR schedule (port of ``srf_tpu/train/optimizer.py``).

Reference parity (tfsr/helper/train_helper.py:32-75):
- ``noam_schedule``: the Speech-Transformer/Noam schedule
  ``lr = min(k * rsqrt(d_model) * min(rsqrt(step), step * warmup^-1.5),
  max_lr)``,
- ``get_optimizer``: default Adam under that schedule with the beta/epsilon
  flags; ``--train-opti-type=adam`` -> plain Adam(lr=k) with optax's
  defaults; ``sgd`` -> SGD(lr=k).

The schedule is read at the count of updates already made, from 0, as
optax reads it: the first update uses ``schedule(0)``, which the 1e-9 floor
makes ~0 (1.2e-14 at k=0.5, d=1, warmup 1200), not ``schedule(1)``.
``torch.optim.Adam`` at base rate 1 with a ``LambdaLR`` over the schedule
does exactly that: LambdaLR sets the rate to ``schedule(0)`` when it is
built and to ``schedule(n)`` after its n-th ``step()``. torch's Adam and
optax's agree on the update (bias-corrected moments, eps outside the
square root).
"""

import torch


def noam_schedule(train_lr_param_k, d_model, warmup_steps, max_lr=10.0):
    def schedule(step):
        step = max(float(step), 1e-9)
        lr = train_lr_param_k * float(d_model) ** -0.5 * min(
            step ** -0.5, step * warmup_steps ** -1.5)
        return min(lr, max_lr)

    return schedule


def get_optimizer(config, params):
    """Returns (optimizer, LambdaLR scheduler or None) over those of
    ``params`` that require a gradient (the LSTM's fixed ``bias_ih`` stays
    out); call ``scheduler.step()`` after each ``optimizer.step()``. The
    schedule function is ``scheduler.lr_lambdas[0]``."""
    params = [p for p in params if p.requires_grad]
    opti_type = config.train_opti_type
    if opti_type is None or opti_type not in ("adam", "sgd"):
        schedule = noam_schedule(
            config.train_lr_param_k,
            config.model_dimension,
            config.train_warmup_n,
            config.train_lr_max,
        )
        optimizer = torch.optim.Adam(
            params, lr=1.0,
            betas=(config.train_adam_beta1, config.train_adam_beta2),
            eps=config.train_adam_epsilon,
        )
        return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                            schedule)
    if opti_type == "adam":  # optax.adam's defaults
        return torch.optim.Adam(params, lr=config.train_lr_param_k,
                                betas=(0.9, 0.999), eps=1e-8), None
    return torch.optim.SGD(params, lr=config.train_lr_param_k), None
