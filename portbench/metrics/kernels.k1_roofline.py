from portbench.readers import k1_roofline as read  # noqa: F401
