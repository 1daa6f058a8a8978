"""UNet trunk with a bilinear decoder, NCHW.

Counterpart of ``im2im_uq_tpu/models/unet.py`` (``DoubleConv``, ``Down``,
``Up``, ``UNet``), and of the reference trunk it rebuilds. The submodule
names are the reference's (``inc.double_conv.0``, ``down1.maxpool_conv.1``,
``up1.conv``, ``out.conv``), which are exactly the keys that
``im2im_uq_tpu.interop.torch_export.export_state_dict`` emits, so a JAX
model's weights load with ``load_state_dict(strict=True)``.

Convolutions and batch norm are PyTorch's own layers (cuDNN on the card,
as the JAX package leaves them to XLA). The decoder's 2x upsample is K1
(``ops/upsample.py``: K1f forward, K1b backward) on a CUDA tensor. ``Down``'s
pool is ``ops/pool.MaxPool2x2``: torch's max-pool forward, K7 as its backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from im2im_uq_tpu_torch.ops.pool import MaxPool2x2
from im2im_uq_tpu_torch.ops.resize import upsample2x_align_corners

__all__ = ["DoubleConv", "Down", "OutConv", "UNet", "Up"]


def _bn(features: int) -> nn.BatchNorm2d:
    # torch's defaults, which the JAX package's TorchBatchNorm reproduces
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class DoubleConv(nn.Module):
    """(conv3x3 → BN → ReLU) × 2."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels if mid_channels is not None else out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, kernel_size=3, padding=1),
            _bn(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, kernel_size=3, padding=1),
            _bn(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    """2×2 max pool (floor on odd sizes), then DoubleConv.

    The pool has no parameters, so the state-dict keys stay
    ``maxpool_conv.1.*``.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(MaxPool2x2(), DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """2x bilinear upsample, centre pad to the skip's size, concat [skip, up], DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        # the kernel takes NCHW-contiguous input; this copies only a
        # channels_last activation
        x1 = upsample2x_align_corners(x1.contiguous())
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            # left/top get diff // 2, right/bottom the rest (unet.py:729-736)
            x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        # the skip comes first: conv0's input-channel order depends on it
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    """1×1 projection to the trunk's feature channels."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet(nn.Module):
    """4-down/4-up UNet, encoder 64/128/256/512/512, decoder 256/128/64/64,
    1×1 out-conv to ``n_channels_middle`` (32) features. Input (B, C, H, W)."""

    def __init__(self, n_channels_in: int = 1, n_channels_out: int = 1,
                 n_channels_middle: int = 32):
        super().__init__()
        self.n_channels_out = n_channels_out
        self.n_channels_middle = n_channels_middle
        self.inc = DoubleConv(n_channels_in, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 512)
        self.up1 = Up(1024, 256)
        self.up2 = Up(512, 128)
        self.up3 = Up(256, 64)
        self.up4 = Up(128, 64)
        self.out = OutConv(64, n_channels_middle)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.out(x)
