"""K1's share of its roofline in the traced train steps:
``readers.sdr_roofline_train``."""

from benchmark.readers import sdr_roofline_train


def read(record):
    return sdr_roofline_train(record, 0)
