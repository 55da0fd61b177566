from portbench.readers import k23_roofline as read  # noqa: F401
