"""Device algorithms: affinity graphs, FD/SWFD sketch, SVD, k-means."""
