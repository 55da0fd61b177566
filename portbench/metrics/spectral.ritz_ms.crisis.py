from portbench import spans

read = spans.mean_ms("spectral.ritz", spans.device_ms)
