"""The device's idle share of the traced serving window:
``readers.idle_share``."""

from benchmark.readers import idle_share as read  # noqa: F401
