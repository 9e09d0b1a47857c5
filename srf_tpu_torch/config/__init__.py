from srf_tpu_torch.config.constants import Constants, ExitCode, Tag
from srf_tpu_torch.config.logger import Logger, get_logger
from srf_tpu_torch.config.options import ParseOption

__all__ = ["Constants", "ExitCode", "Tag", "Logger", "get_logger", "ParseOption"]
