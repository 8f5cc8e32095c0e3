"""Core algorithms: grids, grid tree, merging, labels, device pipeline."""
