"""Multi-device execution over torch.distributed: meshes, sketch-merge
collectives, the row- and column-sharded layouts, the parallel sweep."""
