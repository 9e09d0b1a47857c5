"""How long the front end holds a batch open in the traced serving window:
``spans.hold_ms``."""

from benchmark.spans import hold_ms as read  # noqa: F401
