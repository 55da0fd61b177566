from portbench.readers import k23_launches as read  # noqa: F401
