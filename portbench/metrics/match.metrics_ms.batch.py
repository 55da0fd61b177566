from portbench.spans import batch_metrics_ms as read  # noqa: F401
