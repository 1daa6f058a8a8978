"""CIFAR-10 as an image-to-image dataset (denoising formulation).

The reference router's CIFAR10 branch (reference: core/scripts/router.py:
58-62) builds a torchvision classification dataset that is incompatible
with its own im2im pipeline — vestigial dead code. This carries the branch
over functionally: CIFAR images become (noisy input, clean target) pairs so
the UQ pipeline runs end-to-end. Reads the standard ``cifar-10-batches-py``
pickle layout from a local directory (no downloads).

The port's copy of ``im2im_uq_tpu/data/cifar10.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["CIFAR10Dataset"]


class CIFAR10Dataset:
    def __init__(self, path: str, noise_std: float = 0.1, train: bool = True, seed: int = 0):
        base = os.path.join(path, "cifar-10-batches-py")
        if not os.path.isdir(base):
            base = path
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        chunks = []
        for name in names:
            fp = os.path.join(base, name)
            if not os.path.exists(fp):
                raise FileNotFoundError(
                    f"CIFAR-10 batch {fp} not found; place the standard "
                    "cifar-10-batches-py files under the data path"
                )
            with open(fp, "rb") as fh:
                chunks.append(pickle.load(fh, encoding="bytes")[b"data"])
        data = np.concatenate(chunks).reshape(-1, 3, 32, 32)
        self.images = (np.transpose(data, (0, 2, 3, 1)).astype(np.float32) / 255.0)
        self.noise_std = noise_std
        self.seed = seed
        self.cache_path = None
        self.norm_params: dict = {}

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        clean = self.images[i]
        rng = np.random.RandomState(self.seed * 1000003 + i)
        noisy = clean + self.noise_std * rng.randn(*clean.shape).astype(np.float32)
        return noisy, clean
