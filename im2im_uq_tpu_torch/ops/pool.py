"""K7: the 2×2 stride-2 max pool whose backward is a hand-written kernel.

Counterpart of ``im2im_uq_tpu/ops/pallas_pool.py`` (``max_pool2x2`` and its
custom VJP, which the JAX ``Down`` uses under ``pool_backend: "pallas"``);
the port's ``Down`` always uses it. The forward is PyTorch's
``F.max_pool2d(x, 2)``, as the JAX forward is XLA's ``reduce_window``,
outside Pallas. The backward
is :func:`max_pool2x2_bwd`: on a CUDA tensor it launches the kernel in
``csrc/maxpool2x2_bwd.cu``, on a CPU tensor it runs
:func:`max_pool2x2_bwd_plain`. Nothing else picks between the two.

The gradient of each window goes to its first element, in row-major order,
that equals the window's max (the first-match rule of the TPU kernel and of
torch's own max-pool backward); the rows and columns dropped by floor
pooling on odd sizes get 0. Layout is NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from im2im_uq_tpu_torch import _build

__all__ = ["MaxPool2x2", "max_pool2x2", "max_pool2x2_bwd", "max_pool2x2_bwd_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_pool2x2_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7's plain version: the mask-and-priority rule in PyTorch ops.

    The window max ignores NaN (``torch.fmax``, as the kernel's ``fmaxf``);
    dx holds g's values unchanged where the mask selects them.
    """
    h, w = x.shape[-2:]
    ho, wo = h // 2, w // 2
    win = x[..., : 2 * ho, : 2 * wo].unflatten(-1, (wo, 2)).unflatten(-3, (ho, 2))
    v = [win[..., :, r, :, c] for r in (0, 1) for c in (0, 1)]  # row-major order
    m = torch.fmax(torch.fmax(v[0], v[1]), torch.fmax(v[2], v[3]))
    zero = torch.zeros_like(g)
    taken = torch.zeros_like(m, dtype=torch.bool)
    parts = []
    for vk in v:
        first = (vk == m) & ~taken
        taken = taken | first
        parts.append(torch.where(first, g, zero))
    # (…, ho, wo) × 4 → (…, ho, 2, wo, 2) → (…, 2ho, 2wo)
    quad = torch.stack(parts, -1).unflatten(-1, (2, 2)).transpose(-3, -2)
    dx = quad.reshape(*g.shape[:-2], 2 * ho, 2 * wo)
    return F.pad(dx, [0, w - 2 * wo, 0, h - 2 * ho])


def _launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    for t in (x, g):
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"maxpool2x2_bwd kernel takes float32 or bfloat16, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"maxpool2x2_bwd kernel takes NCHW input, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("maxpool2x2_bwd kernel takes contiguous NCHW tensors")
    b, c, h, w = x.shape
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError("maxpool2x2_bwd kernel takes x and g of one dtype and device")
    if tuple(g.shape) != (b, c, h // 2, w // 2):
        raise ValueError(
            f"maxpool2x2_bwd: cotangent {tuple(g.shape)} does not pool {tuple(x.shape)}"
        )
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    err = _build.library().im2im_maxpool2x2_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), b * c, h, w,
        _KERNEL_DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    max_pool2x2_bwd.launches += 1
    _build.check(err, "maxpool2x2_bwd")
    return dx


def max_pool2x2_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx of the 2×2/2 max pool of ``x`` for the cotangent ``g``.

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; any other device raises.
    """
    if x.device.type == "cuda":
        return _launch(x, g)
    if x.device.type == "cpu":
        return max_pool2x2_bwd_plain(x, g)
    raise RuntimeError(f"max_pool2x2_bwd runs on cuda or cpu tensors, not {x.device}")


max_pool2x2_bwd.launches = 0  # kernel launches since the last reset


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        b, c, h, w = x.shape
        if h < 2 or w < 2:  # nothing to pool; F.max_pool2d refuses an empty output
            return x.new_empty((b, c, h // 2, w // 2))
        return F.max_pool2d(x, 2)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return max_pool2x2_bwd(x.contiguous(), g.contiguous())


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max pool (floor on odd sizes) with K7 as its backward."""
    return _MaxPool2x2.apply(x)


class MaxPool2x2(nn.Module):
    """:func:`max_pool2x2` as a module with no parameters, so that ``Down``'s
    state-dict keys are those of the reference's ``nn.MaxPool2d(2)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool2x2(x)
