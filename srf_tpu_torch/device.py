"""Where the port runs: the CUDA device unless the caller asks for the CPU."""

import torch

from srf_tpu_torch.parallel import distributed


def resolve_device(device=None):
    """``None``/``"cuda"``/``"cuda:N"`` -> that CUDA device; ``"cpu"`` -> CPU.
    Once a process group of more than one rank is up, ``None``/``"cuda"``
    is the rank's own card, ``cuda:LOCAL_RANK``
    (``parallel.distributed.local_device``; it raises where the host has
    no such card).

    A CUDA request with no CUDA device raises: the port never carries on on
    the CPU unless asked to. On CUDA it also turns TF32 off for matmuls and
    cuDNN convolutions: cuDNN runs float32 convolutions in TF32 by default
    (about three decimal digits), which would swamp the float32 parity
    tolerances the port is held to against the JAX reference. And it lets
    cuDNN time its convolution algorithms at each new problem
    (``cudnn.benchmark``, F14): without TF32, cuDNN's heuristics pick an
    FFT tiling for the maxout CNN's (5, 3) convs at some shapes that runs
    8-43x slower than what the search finds (a train step at 29 x 241, a
    serving forward at 29 x 128), and algorithms 13-14 % slower at the
    other train shapes. The full search costs ~40 s at each new CNN train
    shape (207 s over the TIMIT recipe's 5 buckets), most of it timing
    slow weight-gradient candidates, and 0.1-16 s at each new CNN serving
    shape (60 s over 21); the SRF runs at the same speed with or without
    it (PERF.md, ``chip_cnn_numerics.py``). The CNN's convolutions
    (``models/layers.py`` ``conv2d_same``) time fewer candidates where
    ``ops/conv_choice.py``'s kept table holds their problem for this card
    and cuDNN version (the CNN-TIMIT train buckets on an H100): each kept
    problem times only the candidates its full search needed, 13.5 s over
    the 5 buckets against 214 s, each step within 1.5 % of the fully
    searched one. A problem the table does not hold is searched in full,
    at the cost above.
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
    if device.index is None and distributed.world_size() > 1:
        device = distributed.local_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    return device
