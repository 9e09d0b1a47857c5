"""Seconds the process spent choosing convolution algorithms: the summed
length of the program's ``srf.conv.choose`` spans in its ring, each the
choice (kept or searched) at one convolution's shape, which set-up makes
(``spans.program_spans``); None where the program records none."""

from benchmark import spans

NAME = "srf.conv.choose"


def read(record):
    ring = spans.program_spans()
    chosen = [end - start for name, start, end, _, _, _ in ring or ()
              if name == NAME]
    return sum(chosen) / 1e9 if chosen else None
