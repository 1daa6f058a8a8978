"""Deterministic seeding across every RNG the pipeline touches.

Counterpart of ``im2im_uq_tpu/utils/random.py``: seed numpy and Python's
``random`` (data splitting and shuffling draw from them), seed torch's
global generators, and return an explicit ``torch.Generator`` for the
model's init, as the JAX function returns the root key.
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["fix_randomness"]


def fix_randomness(seed: int = 0) -> torch.Generator:
    """Seed numpy, ``random`` and torch; return a CPU generator seeded with
    ``seed`` for parameter init (``add_uncertainty`` draws on the
    generator's device and then moves the weights)."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
