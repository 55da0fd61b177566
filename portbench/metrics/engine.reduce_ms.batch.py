from portbench.spans import batch_reduce_ms as read  # noqa: F401
