"""FastMRI per-slice transform: k-space → masked → image-space input/target.

Host-side numpy counterpart of the reference transform stack (reference:
core/datasets/fastmri/transforms.py — ``to_tensor`` 19-35, ``apply_mask``
53-85, ``center_crop``/``complex_center_crop`` 105-152, ``normalize``/
``normalize_instance`` 180-222, ``UnetDataTransform`` 225-328). Runs in the
loader's thread pool (numpy FFTs on a 640×368 slice are sub-millisecond), so
the TPU never waits on the physics; the same math is available as jitted
device ops in ops/fftc.py for on-device batched pipelines.

The port's copy of ``im2im_uq_tpu/data/transforms.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from im2im_uq_tpu_torch.data.subsample import MaskFunc

__all__ = [
    "to_real_pair",
    "apply_mask",
    "center_crop",
    "complex_center_crop",
    "center_crop_to_smallest",
    "normalize",
    "normalize_instance",
    "mask_center",
    "VarNetDataTransform",
    "ifft2c_np",
    "fft2c_np",
    "complex_abs_np",
    "rss_np",
    "UnetDataTransform",
]


def to_real_pair(data: np.ndarray) -> np.ndarray:
    """Complex ndarray → real array with trailing (re, im) dim (transforms.py:19-35)."""
    if np.iscomplexobj(data):
        return np.stack((data.real, data.imag), axis=-1)
    return data


def _check_pair(data: np.ndarray) -> None:
    if data.shape[-1] != 2:
        raise ValueError("Array does not have separate complex dim.")


def fft2c_np(data: np.ndarray) -> np.ndarray:
    """Centered orthonormal 2-D FFT on real-pair data (fftc.py:61-83)."""
    _check_pair(data)
    z = data[..., 0] + 1j * data[..., 1]
    z = np.fft.fftshift(
        np.fft.fft2(np.fft.ifftshift(z, axes=(-2, -1)), norm="ortho"), axes=(-2, -1)
    )
    return to_real_pair(z)


def ifft2c_np(data: np.ndarray) -> np.ndarray:
    """Centered orthonormal 2-D IFFT on real-pair data (fftc.py:87-110)."""
    _check_pair(data)
    z = data[..., 0] + 1j * data[..., 1]
    z = np.fft.fftshift(
        np.fft.ifft2(np.fft.ifftshift(z, axes=(-2, -1)), norm="ortho"), axes=(-2, -1)
    )
    return to_real_pair(z)


def complex_abs_np(data: np.ndarray) -> np.ndarray:
    _check_pair(data)
    return np.sqrt((data**2).sum(axis=-1))


def rss_np(data: np.ndarray, axis: int = 0) -> np.ndarray:
    return np.sqrt((data**2).sum(axis=axis))


def apply_mask(
    data: np.ndarray,
    mask_func: MaskFunc,
    seed=None,
    padding: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Column-subsample k-space (transforms.py:53-85); zeros keep +0.0 sign."""
    shape = np.array(data.shape)
    shape[:-3] = 1
    mask = mask_func(tuple(shape), seed)
    if padding is not None:
        mask[..., : padding[0], :] = 0
        mask[..., padding[1] :, :] = 0
    return data * mask + 0.0, mask


def center_crop(data: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Center crop over the last two dims (transforms.py:105-127)."""
    if not (0 < shape[0] <= data.shape[-2] and 0 < shape[1] <= data.shape[-1]):
        raise ValueError("Invalid shapes.")
    w0 = (data.shape[-2] - shape[0]) // 2
    h0 = (data.shape[-1] - shape[1]) // 2
    return data[..., w0 : w0 + shape[0], h0 : h0 + shape[1]]


def complex_center_crop(data: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Center crop over dims (-3, -2) of real-pair data (transforms.py:130-152)."""
    if not (0 < shape[0] <= data.shape[-3] and 0 < shape[1] <= data.shape[-2]):
        raise ValueError("Invalid shapes.")
    w0 = (data.shape[-3] - shape[0]) // 2
    h0 = (data.shape[-2] - shape[1]) // 2
    return data[..., w0 : w0 + shape[0], h0 : h0 + shape[1], :]


def center_crop_to_smallest(
    x: np.ndarray, y: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Crop both to the elementwise-min spatial size (transforms.py:155-177)."""
    h = min(x.shape[-2], y.shape[-2])
    w = min(x.shape[-1], y.shape[-1])
    return center_crop(x, (h, w)), center_crop(y, (h, w))


def normalize(data: np.ndarray, mean, stddev, eps=0.0) -> np.ndarray:
    """(data − mean) / (stddev + eps) (transforms.py:180-201)."""
    return (data - mean) / (stddev + eps)


def normalize_instance(data: np.ndarray, eps=0.0):
    """Instance-normalize by the array's own mean/std (transforms.py:204-222)."""
    mean, std = data.mean(), data.std()
    return normalize(data, mean, std, eps), mean, std


def mask_center(x: np.ndarray, mask_from: int, mask_to: int) -> np.ndarray:
    """Zero everything but the center columns (transforms.py:88-102)."""
    out = np.zeros_like(x)
    out[..., mask_from:mask_to, :] = x[..., mask_from:mask_to, :]
    return out


class VarNetDataTransform:
    """k-space-domain transform for VarNet-style models (transforms.py:331-414).

    Returns (masked_kspace, byte mask, target, fname, slice_num, max_value,
    crop_size); the acquisition padding (attrs padding_left/right) zeroes the
    unacquired columns. Unused by the main pipeline, kept for surface parity.
    """

    def __init__(self, mask_func: Optional[MaskFunc] = None, use_seed: bool = True):
        self.mask_func = mask_func
        self.use_seed = use_seed

    def __call__(self, kspace, mask, target, attrs, fname, slice_num):
        if target is not None:
            target = to_real_pair(np.asarray(target))
            max_value = attrs["max"]
        else:
            target = np.zeros(())
            max_value = 0.0
        kspace = to_real_pair(np.asarray(kspace))
        seed = tuple(map(ord, fname)) if self.use_seed else None
        acq_start, acq_end = attrs["padding_left"], attrs["padding_right"]
        crop_size = np.array([attrs["recon_size"][0], attrs["recon_size"][1]])

        if self.mask_func:
            masked_kspace, mask = apply_mask(
                kspace, self.mask_func, seed, (acq_start, acq_end)
            )
        else:
            masked_kspace = kspace
            num_cols = kspace.shape[-2]
            mask_shape = [1] * kspace.ndim
            mask_shape[-2] = num_cols
            mask = np.asarray(mask).reshape(*mask_shape).astype(np.float32)
            mask[..., :acq_start, :] = 0
            mask[..., acq_end:, :] = 0
        return (
            masked_kspace,
            mask.astype(np.uint8),
            target,
            fname,
            slice_num,
            max_value,
            crop_size,
        )


class UnetDataTransform:
    """k-space → (zero-filled input image, target image) for UNet training.

    Same recipe as the reference (transforms.py:225-328): real-pair encode →
    optional mask (seeded per filename when ``use_seed``) → centered IFFT →
    complex center-crop to the recon size (FLAIR-203 fallback when the
    encoded height is narrower) → magnitude → RSS for multicoil → target
    center-cropped to match. Returns numpy (image, target, mean, std, fname,
    slice_num, max_value); instance normalization stays disabled, as in the
    reference (transforms.py:313-315 are commented out there).
    """

    def __init__(
        self,
        which_challenge: str,
        mask_func: Optional[MaskFunc] = None,
        use_seed: bool = True,
    ):
        if which_challenge not in ("singlecoil", "multicoil"):
            raise ValueError("Challenge should either be 'singlecoil' or 'multicoil'")
        self.which_challenge = which_challenge
        self.mask_func = mask_func
        self.use_seed = use_seed

    def __call__(
        self,
        kspace: np.ndarray,
        mask: Optional[np.ndarray],
        target: Optional[np.ndarray],
        attrs: Dict,
        fname: str,
        slice_num: int,
    ):
        kspace = to_real_pair(np.asarray(kspace))
        max_value = attrs.get("max", 0.0)

        if self.mask_func and mask is None:
            seed = tuple(map(ord, fname)) if self.use_seed else None
            masked_kspace, mask = apply_mask(kspace, self.mask_func, seed)
        else:
            masked_kspace = kspace

        image = ifft2c_np(masked_kspace)

        if target is not None:
            crop_size = (target.shape[-2], target.shape[-1])
        else:
            crop_size = (attrs["recon_size"][0], attrs["recon_size"][1])
        if image.shape[-2] < crop_size[1]:  # FLAIR 203 fallback
            crop_size = (image.shape[-2], image.shape[-2])

        image = complex_center_crop(image, crop_size)
        image = complex_abs_np(image)
        if self.which_challenge == "multicoil":
            image = rss_np(image)

        if target is not None:
            target = center_crop(np.asarray(target), crop_size)
        else:
            target = np.zeros((1,), np.float32)

        return image, target, None, None, fname, slice_num, max_value
