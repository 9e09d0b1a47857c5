"""Train state: the model (parameters and BatchNorm statistics), its
optimizer and LR scheduler, the device they live on, the count of updates
made and, with ``--tpu-ema-decay`` or ``--tpu-decode-ema``, an exponential
moving average of the parameters (port of ``srf_tpu/train/state.py``).
PyTorch updates all of them in place, so the state is a plain mutable
record instead of a pytree."""

import dataclasses
from typing import Any, Dict, Optional

import torch

from srf_tpu_torch.device import resolve_device

# JAX's error for --tpu-decode-ema on weights saved without an EMA
NO_EMA = ("--tpu-decode-ema: the checkpoint holds no EMA params "
          "(was it trained with --tpu-ema-decay > 0?)")


def trainable(model):
    """{name: parameter} of ``model``'s trained parameters, keyed as
    ``named_parameters`` (the LSTM's frozen ``bias_ih`` is not one)."""
    return {name: p for name, p in model.named_parameters()
            if p.requires_grad}


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Any] = None
    device: torch.device = torch.device("cuda")
    step: int = 0  # updates made; kept on the host, as is the schedule's
    # EMA of the trained parameters (JAX's ema_params: no BatchNorm
    # statistics), keyed as named_parameters; None without EMA
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model, optimizer, scheduler=None, with_ema=False,
               device=None):
        """Moves ``model`` to ``device`` (``resolve_device``: the CUDA device
        unless ``"cpu"`` is asked for; raises without one). ``optimizer``
        may be built over the parameters before the move: ``Module.to``
        keeps the parameter objects, and Adam makes its moments at the
        first update, on the parameters' device. ``with_ema`` starts the
        EMA at a copy of the parameters (not an alias), so that it needs
        no bias correction."""
        device = resolve_device(device)
        model = model.to(device)
        state = cls(model=model, optimizer=optimizer, scheduler=scheduler,
                    device=device)
        if with_ema:
            state.reset_ema()
        return state

    def reset_ema(self):
        """The EMA set to a copy of the current parameters."""
        self.ema = {name: p.detach().clone()
                    for name, p in trainable(self.model).items()}

    def load_ema_weights(self):
        """The EMA copied into the model's parameters (--tpu-decode-ema;
        the BatchNorm statistics are left as they are). Raises JAX's
        ValueError where the state holds no EMA."""
        if self.ema is None:
            raise ValueError(NO_EMA)
        with torch.no_grad():
            for name, p in trainable(self.model).items():
                p.copy_(self.ema[name])

    def update_ema(self, decay):
        """``ema += (1 - decay) * (p - ema)`` for every trained parameter
        (JAX's update after the optimizer step), in place."""
        from srf_tpu_torch.parallel.sharding_rules import local

        # under FSDP both sides are DTensors of one layout: their shards
        params = trainable(self.model)
        torch._foreach_lerp_([local(e) for e in self.ema.values()],
                             [local(params[name].detach())
                              for name in self.ema],
                             1.0 - decay)


def param_count(model):
    """Trained parameters (the LSTM's fixed ``bias_ih`` is not one, as
    flax's cell has no such bias)."""
    return sum(p.numel() for p in trainable(model).values())
