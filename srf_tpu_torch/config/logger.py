"""TF-style console logger.

Format matches the reference's logging format
(reference: tfsr/helper/common_helper.py:97-132) so log-scraping recipes and
humans see familiar output:
    2020-01-01 10:00:00.000000: I trainer_sr.py:123] message
"""

import logging


class Logger:
    """Create with ``Logger(name=..., level=...).logger``."""

    DEBUG = logging.DEBUG
    NOTSET = logging.NOTSET
    INFO = logging.INFO
    WARN = logging.WARN
    ERROR = logging.ERROR
    CRITICAL = logging.CRITICAL

    def __init__(self, name: str = "__default__", level: int = logging.NOTSET):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(level)
        if not self.logger.handlers:
            handle = logging.StreamHandler()
            handle.setLevel(level)
            formatter = logging.Formatter(
                "%(asctime)s: %(levelname).1s %(filename)s:%(lineno)d] %(message)s"
            )
            formatter.default_msec_format = "%s.%06d"
            handle.setFormatter(formatter)
            self.logger.propagate = False
            self.logger.addHandler(handle)


def get_logger(name: str = "srf_tpu_torch", level: int = logging.INFO):
    return Logger(name=name, level=level).logger
