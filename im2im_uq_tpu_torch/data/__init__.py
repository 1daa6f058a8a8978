"""Datasets and host batching of the PyTorch port (copies of the JAX package's host data modules)."""
