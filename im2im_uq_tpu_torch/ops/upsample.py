"""K1: the 2x align-corners bilinear upsample of every decoder level.

Counterpart of ``im2im_uq_tpu/ops/pallas_resize.py`` (forward). On a CUDA
tensor :func:`upsample2x` launches the hand-written kernel in
``csrc/upsample2x.cu``; on a CPU tensor it runs :func:`upsample2x_plain`,
the same phase lerp in PyTorch ops. Nothing else picks between the two.

Layout is NCHW: the upsample works on the last two axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from im2im_uq_tpu_torch import _build

__all__ = ["phase_weights", "upsample2x", "upsample2x_axis_plain", "upsample2x_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def phase_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Even/odd-phase lerp fractions of the exact-2x align-corners resize.

    Output 2m = x[m-1] + (x[m]-x[m-1])·fe[m]; output 2m+1 = x[m] +
    (x[m+1]-x[m])·fo[m]. Built in float64 and cast to float32, with
    fe[0] = 1, exactly as ``pallas_resize._phase_weights``.
    """
    if n == 1:
        return np.ones((1,), np.float32), np.zeros((1,), np.float32)
    m = np.arange(n, dtype=np.float64)
    scale = (n - 1) / (2 * n - 1)
    f_even = (2 * m * scale - (m - 1)).astype(np.float32)
    f_even[0] = 1.0
    f_odd = ((2 * m + 1) * scale - m).astype(np.float32)
    return f_even, f_odd


def upsample2x_axis_plain(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact-2x align-corners upsample along ``dim``: two shifted lerps and
    an interleave (``im2im_uq_tpu/ops/resize._upsample2x_axis``)."""
    n = x.shape[dim]
    xm1 = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    xp1 = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    fe, fo = phase_weights(n)
    shape = [1] * x.ndim
    shape[dim] = n
    fe = torch.from_numpy(fe).to(x.device, x.dtype).reshape(shape)
    fo = torch.from_numpy(fo).to(x.device, x.dtype).reshape(shape)
    even = xm1 + (x - xm1) * fe
    odd = x + (xp1 - x) * fo
    out_shape = list(x.shape)
    out_shape[dim] = 2 * n
    return torch.stack([even, odd], dim + 1).reshape(out_shape)


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """K1's plain version: lerp along H, then W, in f32; one rounding at the end."""
    y = x.float()
    y = upsample2x_axis_plain(y, x.ndim - 2)
    y = upsample2x_axis_plain(y, x.ndim - 1)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _weight_table(n: int, device: torch.device) -> torch.Tensor:
    """(2n,) f32 table [fe | fo] on ``device``, kept per size."""
    fe, fo = phase_weights(n)
    return torch.from_numpy(np.concatenate([fe, fo])).to(device)


def _launch(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"upsample2x kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"upsample2x kernel takes NCHW input, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("upsample2x kernel takes a contiguous NCHW tensor")
    b, c, h, w = x.shape
    y = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    wh, ww = _weight_table(h, x.device), _weight_table(w, x.device)
    err = _build.library().im2im_upsample2x(
        x.data_ptr(), y.data_ptr(), wh.data_ptr(), ww.data_ptr(),
        b * c, h, w, _KERNEL_DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    upsample2x.launches += 1
    _build.check(err, "upsample2x")
    return y


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), bilinear with align_corners=True.

    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version; any other device raises.
    """
    if x.device.type == "cuda":
        return _launch(x)
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    raise RuntimeError(f"upsample2x runs on cuda or cpu tensors, not {x.device}")


upsample2x.launches = 0  # kernel launches since the last reset
