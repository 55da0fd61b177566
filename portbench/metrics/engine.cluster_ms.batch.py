from portbench.spans import batch_cluster_ms as read  # noqa: F401
