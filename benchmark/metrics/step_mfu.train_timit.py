"""The TIMIT training cells' model FLOPs utilisation: ``readers.step_mfu``."""

from benchmark.readers import step_mfu as read  # noqa: F401
