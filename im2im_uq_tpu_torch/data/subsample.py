"""k-space undersampling masks (GRAPPA-style) with seeded RNG isolation.

Counterpart of the reference mask layer (reference: core/datasets/fastmri/
subsample.py:15-222 — ``temp_seed``, ``MaskFunc``, ``RandomMaskFunc``,
``EquispacedMaskFunc``, ``create_mask_for_mask_type``). Masks are tiny
1-D column selectors generated host-side in numpy; RNG draw order matches
the reference exactly (acceleration choice → column draws) so a given
(seed, shape) produces the identical mask, which is what makes per-volume
masks reproducible across epochs (transforms.py seeds by filename).

Masks broadcast against k-space of shape (..., H, W, 2): all dims size 1
except the width (second-to-last) axis.

The port's copy of ``im2im_uq_tpu/data/subsample.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "temp_seed",
    "MaskFunc",
    "RandomMaskFunc",
    "EquispacedMaskFunc",
    "create_mask_for_mask_type",
]

Seed = Optional[Union[int, Tuple[int, ...]]]


@contextlib.contextmanager
def temp_seed(rng: np.random.RandomState, seed: Seed):
    """Temporarily reseed ``rng``; restore its state on exit (subsample.py:15-28)."""
    if seed is None:
        yield
        return
    state = rng.get_state()
    rng.seed(seed)
    try:
        yield
    finally:
        rng.set_state(state)


class MaskFunc:
    """Base sampler: dense low-frequency center + undersampled periphery."""

    def __init__(self, center_fractions: Sequence[float], accelerations: Sequence[int]):
        if len(center_fractions) != len(accelerations):
            raise ValueError(
                "Number of center fractions should match number of accelerations"
            )
        self.center_fractions = list(center_fractions)
        self.accelerations = list(accelerations)
        self.rng = np.random.RandomState()

    def choose_acceleration(self) -> tuple[float, int]:
        choice = self.rng.randint(0, len(self.accelerations))
        return self.center_fractions[choice], self.accelerations[choice]

    def _column_mask(self, num_cols: int) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, shape: Sequence[int], seed: Seed = None) -> np.ndarray:
        """Mask of float32 broadcastable to ``shape`` (cols on axis -2)."""
        if len(shape) < 3:
            raise ValueError("Shape should have 3 or more dimensions")
        with temp_seed(self.rng, seed):
            cols = self._column_mask(shape[-2])
        out_shape = [1] * len(shape)
        out_shape[-2] = shape[-2]
        return cols.reshape(out_shape).astype(np.float32)


def _center_pad(num_cols: int, num_low_freqs: int) -> int:
    return (num_cols - num_low_freqs + 1) // 2


class RandomMaskFunc(MaskFunc):
    """Uniform-random columns at the rate that hits N/acceleration in
    expectation, plus the dense center (subsample.py:71-133)."""

    def _column_mask(self, num_cols: int) -> np.ndarray:
        center_fraction, acceleration = self.choose_acceleration()
        num_low = int(round(num_cols * center_fraction))
        prob = (num_cols / acceleration - num_low) / (num_cols - num_low)
        mask = self.rng.uniform(size=num_cols) < prob
        pad = _center_pad(num_cols, num_low)
        mask[pad : pad + num_low] = True
        return mask


class EquispacedMaskFunc(MaskFunc):
    """Equispaced columns at an acceleration adjusted for the dense center,
    with a random phase offset (subsample.py:136-202)."""

    def _column_mask(self, num_cols: int) -> np.ndarray:
        center_fraction, acceleration = self.choose_acceleration()
        num_low = int(round(num_cols * center_fraction))
        mask = np.zeros(num_cols, dtype=np.float32)
        pad = _center_pad(num_cols, num_low)
        mask[pad : pad + num_low] = True
        adjusted_accel = (acceleration * (num_low - num_cols)) / (
            num_low * acceleration - num_cols
        )
        offset = self.rng.randint(0, round(adjusted_accel))
        samples = np.around(np.arange(offset, num_cols - 1, adjusted_accel)).astype(
            np.uint64
        )
        mask[samples] = True
        return mask > 0


def create_mask_for_mask_type(
    mask_type_str: str,
    center_fractions: Sequence[float],
    accelerations: Sequence[int],
) -> MaskFunc:
    """Factory (subsample.py:205-222)."""
    if mask_type_str == "random":
        return RandomMaskFunc(center_fractions, accelerations)
    if mask_type_str == "equispaced":
        return EquispacedMaskFunc(center_fractions, accelerations)
    raise ValueError(f"{mask_type_str} not supported")
