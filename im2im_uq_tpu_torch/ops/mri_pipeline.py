"""On-device MRI pipeline: k-space → model input, inside the train step.

Counterpart of ``im2im_uq_tpu/ops/mri_pipeline.py``. The reference runs its
physics on the host, one slice at a time, in the data loader (mask →
ifft2c → complex_center_crop → complex_abs → rss). Here the same math runs
batched on the model's device: pass a closure over
:func:`zero_filled_recon` (``data/fastmri.FastMRIDataset.device_preprocess``)
as the ``preprocess`` argument of ``training.train.make_train_step`` and the
loader ships raw k-space, which the step turns into the model's input before
the forward. Mask *generation* stays on the host (``data/subsample.py``),
with the reference's per-volume seeding.

The k-space batch keeps the loader's layout (B[, coils], H, W, 2), whose
last dim is the complex pair; the reconstruction comes out NCHW,
(B, 1, ch, cw), the layout of the port's models.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from im2im_uq_tpu_torch.ops.fftc import complex_abs, ifft2c, rss

__all__ = ["complex_center_crop", "center_crop", "zero_filled_recon"]


def _origin(h: int, w: int, shape: Tuple[int, int]) -> tuple[int, int]:
    ch, cw = shape
    if not (0 < ch <= h and 0 < cw <= w):
        raise ValueError(f"crop {shape} invalid for input {(h, w)}")
    return (h - ch) // 2, (w - cw) // 2


def complex_center_crop(data: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Center-crop dims (-3, -2) of a real-pair tensor (a view)."""
    h0, w0 = _origin(data.shape[-3], data.shape[-2], shape)
    return data[..., h0 : h0 + shape[0], w0 : w0 + shape[1], :]


def center_crop(data: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Center-crop the last two dims (a view)."""
    h0, w0 = _origin(data.shape[-2], data.shape[-1], shape)
    return data[..., h0 : h0 + shape[0], w0 : w0 + shape[1]]


def zero_filled_recon(
    kspace_pair: torch.Tensor,
    mask: Optional[torch.Tensor],
    crop: Tuple[int, int],
    multicoil: bool = False,
) -> torch.Tensor:
    """Batched masked zero-filled reconstruction, NCHW output.

    The host ``UnetDataTransform``'s recipe: ``kspace_pair`` is
    (B[, coils], H, W, 2) real-pair k-space; ``mask`` broadcasts against it
    (e.g. (1, 1, W, 1) for a column mask) and may be None (the loader has
    applied it, or the k-space is fully sampled). Returns the (B, 1, ch, cw)
    magnitude images, on the k-space's device.
    """
    masked = kspace_pair if mask is None else kspace_pair * mask
    img = complex_center_crop(ifft2c(masked), crop)
    mag = complex_abs(img)
    if multicoil:
        mag = rss(mag, axis=1)  # (B, coils, h, w) → (B, h, w)
    return mag.unsqueeze(1)
