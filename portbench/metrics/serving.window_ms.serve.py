from portbench.spans import serving_window_ms as read  # noqa: F401
