from srf_tpu_torch.models.cnn import CNNEncoder, CNNStrideEncoder
from srf_tpu_torch.models.decoder import DecoderBlock, EncoderMFBlock
from srf_tpu_torch.models.layers import (
    ConvFrontEnd,
    EncoderBlock,
    MultiHeadAttention,
    PointWiseFeedForward,
)
from srf_tpu_torch.models.lstm import LstmEncoder
from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.models.stf import ConvEncoder

__all__ = [
    "CNNEncoder", "CNNStrideEncoder", "ConvEncoder", "ConvFrontEnd",
    "DecoderBlock", "EncoderBlock", "EncoderMFBlock", "LstmEncoder",
    "MultiHeadAttention", "PointWiseFeedForward", "SequenceRouter",
    "build_model",
]
