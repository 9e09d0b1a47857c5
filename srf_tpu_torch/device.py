"""Where the port runs: the CUDA device unless the caller asks for the CPU."""

import torch


def resolve_device(device=None):
    """``None``/``"cuda"``/``"cuda:N"`` -> that CUDA device; ``"cpu"`` -> CPU.

    A CUDA request with no CUDA device raises: the port never carries on on
    the CPU unless asked to. On CUDA it also turns TF32 off for matmuls and
    cuDNN convolutions: cuDNN runs float32 convolutions in TF32 by default
    (about three decimal digits), which would swamp the float32 parity
    tolerances the port is held to against the JAX reference.
    """
    device = torch.device(device or "cuda")
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError("unsupported device %r (use cuda or cpu)" % str(device))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device=cpu) "
            "to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
