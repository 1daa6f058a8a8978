"""ResNet-18 trunk, NCHW.

Counterpart of ``im2im_uq_tpu/models/resnet.py``: a CIFAR-style 3×3 stem
(64 channels, no bias) with BatchNorm and ReLU, eight basic blocks
(64, 64, 128/2, 128, 256/2, 256, 512/2, 512; two 3×3 convs without bias,
each with BatchNorm, and a 1×1 projection with its BatchNorm where the
block changes the shape), a 1×1 ``out`` conv with bias to
``n_channels_middle`` (32) channels, and the bilinear resize
(align_corners=True) back to the input's height and width, so that every
head works on it. The features come out float32.

The submodule names are the JAX module's (``stem``, ``stem_bn``,
``block{i}.conv1`` / ``bn1`` / ``conv2`` / ``bn2`` / ``proj`` /
``bn_proj``, ``out``), which is the layout
``interop/from_jax.state_dict_from_jax`` maps the JAX tree to (the JAX
package has no export layout for this trunk). The convs run in ``dtype``
(float32 or bfloat16, the JAX ``dtype``), through PyTorch's own conv (cuDNN
on the card): the JAX trunk runs XLA's convs under every ``conv_backend``,
and its strided convs have no Pallas kernel. BatchNorm is torch's in
float32 and flax's in bfloat16 (``models/unet.py``), and the resize is the
per-axis lerps of ``ops/resize.resize_bilinear_align_corners``, which is
not a 2x upsample, so no K1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from im2im_uq_tpu_torch.models.unet import (
    _bn,
    batch_norm,
    batch_norm_low_precision,
    compute_cast,
)
from im2im_uq_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["ResNet18"]

# (features, stride) of the eight blocks
BLOCKS = [(64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1)]


def _norm(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype, train: bool) -> torch.Tensor:
    if dtype == torch.float32:
        return batch_norm(bn, x)
    return batch_norm_low_precision(bn, x, train)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else compute_cast(conv.bias, dtype)
    return F.conv2d(compute_cast(x, dtype), compute_cast(conv.weight, dtype), bias,
                    conv.stride, conv.padding)


class _BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, padding=1, bias=False)
        self.bn2 = _bn(features)
        if stride != 1 or in_channels != features:
            self.proj = nn.Conv2d(in_channels, features, 1, stride, bias=False)
            self.bn_proj = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, train = self.dtype, self.training
        y = F.relu(_norm(self.bn1, _conv(self.conv1, x, dt), dt, train))
        y = _norm(self.bn2, _conv(self.conv2, y, dt), dt, train)
        residual = x
        if hasattr(self, "proj"):
            residual = _norm(self.bn_proj, _conv(self.proj, x, dt), dt, train)
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """ResNet-18 feature trunk emitting ``n_channels_middle`` float32
    channels at the input's resolution (module docstring)."""

    def __init__(self, n_channels_in: int = 1, n_channels_out: int = 1,
                 n_channels_middle: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_channels_out = n_channels_out
        self.n_channels_middle = n_channels_middle
        self.dtype = dtype
        self.stem = nn.Conv2d(n_channels_in, 64, 3, padding=1, bias=False)
        self.stem_bn = _bn(64)
        cin = 64
        for i, (features, stride) in enumerate(BLOCKS):
            setattr(self, f"block{i}", _BasicBlock(cin, features, stride, dtype))
            cin = features
        self.out = nn.Conv2d(cin, n_channels_middle, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        y = F.relu(_norm(self.stem_bn, _conv(self.stem, x, self.dtype), self.dtype,
                         self.training))
        for i in range(len(BLOCKS)):
            y = getattr(self, f"block{i}")(y)
        y = _conv(self.out, y, self.dtype)
        return resize_bilinear_align_corners(y, (h, w)).float()
