from portbench.spans import serving_queue_wait_ms as read  # noqa: F401
