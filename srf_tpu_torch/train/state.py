"""Train state: the model (parameters and BatchNorm statistics), its
optimizer and LR scheduler, the device they live on and the count of
updates made (port of ``srf_tpu/train/state.py``). PyTorch updates all of
them in place, so the state is a plain mutable record instead of a
pytree."""

import dataclasses
from typing import Any, Optional

import torch

from srf_tpu_torch.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Any] = None
    device: torch.device = torch.device("cuda")
    step: int = 0  # updates made; kept on the host, as is the schedule's

    @classmethod
    def create(cls, model, optimizer, scheduler=None, with_ema=False,
               device=None):
        """Moves ``model`` to ``device`` (``resolve_device``: the CUDA device
        unless ``"cpu"`` is asked for; raises without one). ``optimizer``
        may be built over the parameters before the move: ``Module.to``
        keeps the parameter objects, and Adam makes its moments at the
        first update, on the parameters' device."""
        if with_ema:
            raise NotImplementedError(
                "EMA of the parameters (--tpu-ema-decay) is not ported yet: "
                "a later slice of the PyTorch port"
            )
        device = resolve_device(device)
        return cls(model=model.to(device), optimizer=optimizer,
                   scheduler=scheduler, device=device)


def param_count(model):
    """Trained parameters (the LSTM's fixed ``bias_ih`` is not one, as
    flax's cell has no such bias)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
