"""Device idle under the front end's batch spans in the traced serving
window: ``spans.recognizer_idle``."""

from benchmark.spans import recognizer_idle as read  # noqa: F401
