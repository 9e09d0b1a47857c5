"""Device idle under the data feed's spans in the traced train window:
``spans.feed_idle``."""

from benchmark.spans import feed_idle as read  # noqa: F401
