from portbench import spans

read = spans.mean_count("serving.finalized_early")
