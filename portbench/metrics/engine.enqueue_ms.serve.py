from portbench.spans import serving_enqueue_ms as read  # noqa: F401
