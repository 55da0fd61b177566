from portbench.spans import serving_finalize_ms as read  # noqa: F401
