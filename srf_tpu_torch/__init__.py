"""srf_tpu_torch: the Sequential Routing Framework in PyTorch, for NVIDIA H100.

A port of ``srf_tpu`` (JAX/flax/Pallas on TPU), which stays beside it as the
reference. Module names follow ``srf_tpu`` so each counterpart is easy to
find; public functions keep its layouts (activations ``[B, T, F, C]``,
capsules ``[B, T, n, d]``, routing weights ``[in_n, out_n, out_d, in_d]``).

The port imports nothing of ``srf_tpu`` or JAX. Its entry points run on the
CUDA device unless the caller asks for the CPU (``device="cpu"`` /
``--device=cpu``). Every Pallas kernel that a ported path runs is a
hand-written CUDA kernel here (``csrc/``), built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
