"""K1's share of its roofline in the traced serving window:
``readers.sdr_fwd_roofline_serve``."""

from benchmark.readers import sdr_fwd_roofline_serve as read  # noqa: F401
