"""Bilinear resizes with align-corners semantics, NCHW.

Counterpart of ``im2im_uq_tpu/ops/resize.py``. The decoder calls
:func:`upsample2x_align_corners`, which is K1's autograd function
(``ops/upsample.py``): the CUDA kernels K1f and K1b on a CUDA tensor, the
plain phase lerp and its transpose on a CPU tensor.
:func:`resize_bilinear_align_corners` is the general resize of the JAX
package, kept for other scale factors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from im2im_uq_tpu_torch.ops.upsample import upsample2x, upsample2x_axis_plain

__all__ = ["resize_bilinear_align_corners", "upsample2x_align_corners"]


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


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    if out_size == 2 * x.shape[dim]:
        return upsample2x_axis_plain(x, dim)
    i0, i1, frac = _tap_tables(x.shape[dim], out_size)
    lo = x.index_select(dim, torch.from_numpy(i0).to(x.device))
    hi = x.index_select(dim, torch.from_numpy(i1).to(x.device))
    shape = [1] * x.ndim
    shape[dim] = out_size
    f = torch.from_numpy(frac).to(x.device, x.dtype).reshape(shape)
    return lo + (hi - lo) * f


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes with align_corners=True (H, then W).

    An exact 2x of both axes is K1 (:func:`upsample2x`); other sizes run the
    per-axis lerps in PyTorch ops.
    """
    h_dim, w_dim = x.ndim - 2, x.ndim - 1
    if x.ndim == 4 and tuple(out_hw) == (2 * x.shape[h_dim], 2 * x.shape[w_dim]):
        return upsample2x(x.contiguous())
    if x.shape[h_dim] != out_hw[0]:
        x = _resize_axis(x, out_hw[0], h_dim)
    if x.shape[w_dim] != out_hw[1]:
        x = _resize_axis(x, out_hw[1], w_dim)
    return x


# The JAX package's name for the decoder upsample: K1f/K1b on CUDA, their
# plain versions on the CPU.
upsample2x_align_corners = upsample2x
