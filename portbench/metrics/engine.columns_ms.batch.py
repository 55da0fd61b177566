from portbench.spans import batch_columns_ms as read  # noqa: F401
