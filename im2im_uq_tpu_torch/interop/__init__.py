"""Weights from the JAX package."""
