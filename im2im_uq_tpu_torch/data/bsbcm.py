"""BSBCM tensor-pair dataset (blind speckle-based coherence microscopy).

Counterpart of the reference BSBCM loader (reference: core/datasets/bsbcm/
BSBCMDataset.py:10-39): loads whole X/Y tensors into RAM, optional
``num_instances`` truncation, eager whole-tensor standard or min-max
normalization with the reference's norm-params dict keys. Accepts either
torch ``X.pth``/``Y.pth`` files (loaded via torch, converted to numpy) or
``X.npy``/``Y.npy``. Emits NHWC float32 pairs.

The port's copy of ``im2im_uq_tpu/data/bsbcm.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import os

import numpy as np

from im2im_uq_tpu_torch.data.normalize import normalize_array

__all__ = ["BSBCMDataset"]


def _load_tensor(path_base: str, name: str) -> np.ndarray:
    npy = os.path.join(path_base, f"{name}.npy")
    if os.path.exists(npy):
        return np.load(npy)
    pth = os.path.join(path_base, f"{name}.pth")
    if os.path.exists(pth):
        import torch

        return torch.load(pth, map_location="cpu", weights_only=False).numpy()
    raise FileNotFoundError(f"neither {npy} nor {pth} exists")


class BSBCMDataset:
    """In-RAM (input, target) image pairs with eager normalization."""

    def __init__(self, path: str, num_instances="all", normalize=None):
        print(f"loading dataset from {path}...")
        x = _load_tensor(path, "X").astype(np.float32)
        y = _load_tensor(path, "Y").astype(np.float32)
        if x.ndim == 4 and x.shape[1] <= 4 < x.shape[-1]:
            # CHW → HWC for channels-first sources (the reference's torch pairs)
            x = np.moveaxis(x, 1, -1)
            y = np.moveaxis(y, 1, -1)
        if num_instances != "all":
            n = int(num_instances)
            if n > x.shape[0]:
                raise ValueError(
                    f"Dataset only has {x.shape[0]} instances, please try again"
                )
            x, y = x[:n], y[:n]
        print(f"loaded {x.shape[0]} instances")
        self.x, self.y = x, y
        self.norm_params: dict = {}
        self.cache_path = None

        if normalize:
            print(f"normalizing via {normalize} normalization ...")
            self.x, params = normalize_array(self.x, normalize, per_pixel=False, tag="input")
            self.y, params_y = normalize_array(self.y, normalize, per_pixel=False, tag="output")
            params.update(params_y)
            self.params = params

    def __len__(self) -> int:
        return self.x.shape[0]

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        return self.x[idx], self.y[idx]
