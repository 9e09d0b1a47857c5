"""The served batches' model FLOPs utilisation: ``readers.batch_mfu``."""

from benchmark.readers import batch_mfu as read  # noqa: F401
