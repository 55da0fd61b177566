from portbench.spans import serving_featurize_ms as read  # noqa: F401
