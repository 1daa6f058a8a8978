"""Checkpoints of calibrated models."""
