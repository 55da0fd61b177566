from portbench.spans import huge_device_allocs as read  # noqa: F401
