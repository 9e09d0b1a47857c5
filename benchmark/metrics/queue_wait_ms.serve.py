"""A request's wait in the front end's queue in the traced serving window:
``spans.queue_wait_ms``."""

from benchmark.spans import queue_wait_ms as read  # noqa: F401
