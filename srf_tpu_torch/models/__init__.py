from srf_tpu_torch.models.layers import ConvFrontEnd
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.models.srf import SequenceRouter

__all__ = ["ConvFrontEnd", "SequenceRouter", "build_model"]
