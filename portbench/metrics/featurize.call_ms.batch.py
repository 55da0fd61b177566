from portbench.spans import batch_featurize_ms as read  # noqa: F401
