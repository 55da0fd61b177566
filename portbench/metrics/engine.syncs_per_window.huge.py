from portbench.readers import syncs_per_window as read  # noqa: F401
