from portbench.spans import serving_held_ms as read  # noqa: F401
