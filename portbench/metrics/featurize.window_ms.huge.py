from portbench.spans import huge_featurize_ms as read  # noqa: F401
