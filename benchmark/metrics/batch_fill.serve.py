"""How full the front end's batches ran in the window:
``readers.batch_fill``."""

from benchmark.readers import batch_fill as read  # noqa: F401
