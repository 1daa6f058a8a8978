"""Synthetic image-to-image dataset for tests, demos, and benchmarks.

The reference has no synthetic data — its integration test needs the real
FastMRI download at a hard-coded cluster path (reference:
tests/test_add_uncertainty/main.py:35). This generator produces
deterministic (input, target) pairs with FastMRI-like statistics (smooth
structures + noise, heteroscedastic residuals) so the entire
train→calibrate→evaluate pipeline runs hermetically.

The port's copy of ``im2im_uq_tpu/data/synthetic.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticDataset"]


class SyntheticDataset:
    """Deterministic pairs: target = smooth field; input = blurred + noisy view.

    The degradation's noise level varies spatially, so uncertainty heads
    have real signal to learn. Examples are generated on first access and
    cached (the dataset is small by construction).
    """

    def __init__(
        self,
        num_examples: int = 64,
        image_size: int = 64,
        num_channels_in: int = 1,
        seed: int = 0,
        cache_path: str | None = None,
    ):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_channels_in = num_channels_in
        self.seed = seed
        self.cache_path = cache_path
        self.norm_params: dict = {}
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.num_examples

    def _make(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + i)
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        target = np.zeros((s, s), np.float32)
        for _ in range(4):
            cx, cy, sig, amp = rng.rand(4).astype(np.float32)
            sig = 0.05 + 0.2 * sig
            target += amp * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig**2)))
        target = (target - target.min()) / max(target.max() - target.min(), 1e-8)

        # blur via separable box filter, then add spatially-varying noise
        k = 5
        kernel = np.ones(k, np.float32) / k
        blurred = np.apply_along_axis(
            lambda r: np.convolve(r, kernel, mode="same"), 1, target
        )
        blurred = np.apply_along_axis(
            lambda c: np.convolve(c, kernel, mode="same"), 0, blurred
        )
        noise_scale = 0.02 + 0.08 * xx  # heteroscedastic across width
        inp = blurred + noise_scale * rng.randn(s, s).astype(np.float32)

        x = np.repeat(inp[..., None], self.num_channels_in, axis=-1).astype(np.float32)
        y = target[..., None].astype(np.float32)
        return x, y

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        i = int(i)
        if i < 0 or i >= self.num_examples:
            raise IndexError(i)
        if i not in self._cache:
            self._cache[i] = self._make(i)
        return self._cache[i]
