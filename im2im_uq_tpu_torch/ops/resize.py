"""Bilinear resizes with align-corners semantics, NCHW.

Counterpart of ``im2im_uq_tpu/ops/resize.py``. The decoder calls
:func:`upsample2x_align_corners`, which routes as the JAX package's does
(``resize.py:205-254`` on one device): K1's autograd function
(``ops/upsample.py``: the CUDA kernels K1f and K1b on a CUDA tensor, their
plain versions on a CPU tensor) where the TPU kernel takes the shape
(``upsample.pallas_upsample_eligible``) and the backend is not ``"xla"``,
and otherwise :func:`upsample2x_xla`, the JAX package's XLA form in
PyTorch ops with autograd's backward. :func:`resize_bilinear_align_corners`
is the general resize of the JAX package, always in that form.

A height-sharded forward (``parallel/spatial.py``) computes a rank's rows of
a resize from a window of the input's rows, with the taps in global
coordinates (:func:`axis_taps`, :func:`resize_rows`): the same lerps, on the
same values, as the one-device form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from im2im_uq_tpu_torch.ops.constants import device_constants
from im2im_uq_tpu_torch.ops.upsample import (
    pallas_upsample_eligible,
    phase_weights,
    upsample2x,
    upsample2x_axis_plain,
)

__all__ = [
    "axis_taps", "resize_bilinear_align_corners", "resize_rows", "upsample2x_align_corners",
    "upsample2x_xla",
]


@functools.lru_cache(maxsize=128)
def _tap_tables(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static align-corners taps: (i0, i1, frac) per output index."""
    if out_size == 1 or in_size == 1:
        pos = np.zeros((out_size,), np.float64)
    else:
        pos = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (pos - i0).astype(np.float32)
    return i0, i1, frac


def axis_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The global taps (i0, i1, frac) of an axis's align-corners resize as
    the one-device form takes them: output u = x[i0] + (x[i1] − x[i0])·frac.
    An exact 2x is ``upsample2x_axis_plain``'s phase lerps (output 2m from
    x[m − 1] to x[m] by fe[m], output 2m + 1 from x[m] to x[m + 1] by
    fo[m], clamped at the edges), any other size :func:`_tap_tables`."""
    if out_size != 2 * in_size:
        return _tap_tables(in_size, out_size)
    m = np.arange(in_size)
    fe, fo = phase_weights(in_size)
    i0 = np.stack([np.maximum(m - 1, 0), m], 1).reshape(-1)
    i1 = np.stack([m, np.minimum(m + 1, in_size - 1)], 1).reshape(-1)
    return i0, i1, np.stack([fe, fo], 1).reshape(-1)


def resize_rows(x: torch.Tensor, offset: int, in_size: int, out_size: int, start: int,
                stop: int) -> torch.Tensor:
    """Output rows [start, stop) of the align-corners resize of the height
    from ``in_size`` to ``out_size`` rows, taken from ``x``, the window of
    the input's global rows [offset, offset + x.shape[2]); the width is
    left as it is. Each row is the one-device form's lerp of the same two
    input rows (:func:`axis_taps`), so the rows are its rows bit for bit."""
    i0, i1, frac = (a[start:stop] for a in axis_taps(in_size, out_size))
    i0, i1 = i0 - offset, i1 - offset
    if stop > start and (i0.min() < 0 or i1.max() >= x.shape[2]):
        raise ValueError(f"rows [{offset}, {offset + x.shape[2]}) of {in_size} do not hold the "
                         f"taps of output rows [{start}, {stop})")
    lo = x.index_select(2, torch.from_numpy(i0).to(x.device))
    hi = x.index_select(2, torch.from_numpy(i1).to(x.device))
    f = torch.from_numpy(frac).to(x.device, x.dtype).reshape(1, 1, -1, 1)
    return lo + (hi - lo) * f


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    if out_size == 2 * x.shape[dim]:
        return upsample2x_axis_plain(x, dim)
    i0, i1, frac = _tap_tensors(x.shape[dim], out_size, x.device, x.dtype)
    lo = x.index_select(dim, i0)
    hi = x.index_select(dim, i1)
    shape = [1] * x.ndim
    shape[dim] = out_size
    return lo + (hi - lo) * frac.reshape(shape)


def _tap_tensors(in_size: int, out_size: int, device: torch.device,
                 dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_tap_tables` on ``device``, the fractions in ``dtype``, kept per
    size (``ops/constants.py``)."""
    def build():
        i0, i1, frac = _tap_tables(in_size, out_size)
        return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
                torch.from_numpy(frac).to(device, dtype))

    return device_constants(("taps", in_size, out_size, device, dtype), (in_size, out_size),
                            build)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes with align_corners=True (H, then
    W), per-axis lerps in PyTorch ops in x's dtype, as the JAX package's
    (an exact 2x of an axis is ``_upsample2x_axis``'s phase lerp)."""
    h_dim, w_dim = x.ndim - 2, x.ndim - 1
    if x.shape[h_dim] != out_hw[0]:
        x = _resize_axis(x, out_hw[0], h_dim)
    if x.shape[w_dim] != out_hw[1]:
        x = _resize_axis(x, out_hw[1], w_dim)
    return x


def upsample2x_xla(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA form of the 2x upsample (``_upsample2x_axis``
    along H, then W) in x's dtype: in bf16 each operation is rounded on its
    own, with the phase weights in bf16. Its backward is autograd's."""
    return resize_bilinear_align_corners(x, (2 * x.shape[-2], 2 * x.shape[-1]))


def upsample2x_align_corners(x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), bilinear with align_corners=True, the
    decoder's upsample. K1 (:func:`upsample2x`: K1f forward, K1b backward)
    where the NHWC shape is eligible for the TPU kernel and ``backend`` is
    not ``"xla"``; :func:`upsample2x_xla` otherwise. Shape and config
    decide, as in ``im2im_uq_tpu/ops/resize.py:231-254`` on one device."""
    b, c, h, w = x.shape
    if backend != "xla" and pallas_upsample_eligible((b, h, w, c), x.dtype):
        return upsample2x(x.contiguous())
    return upsample2x_xla(x)
