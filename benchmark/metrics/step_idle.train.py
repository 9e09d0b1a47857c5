"""Device idle under the train step's spans in the traced train window:
``spans.step_idle``."""

from benchmark.spans import step_idle as read  # noqa: F401
