"""Numpy data layer: copies of the JAX package's synthetic data,
partitioning and loaders, byte-identical in output."""
