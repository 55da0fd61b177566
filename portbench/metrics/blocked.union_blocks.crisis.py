from portbench import spans

read = spans.mean_count("blocked.union_blocks")
