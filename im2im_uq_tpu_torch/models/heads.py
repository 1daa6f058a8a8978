"""Uncertainty heads, NCHW.

Counterpart of ``im2im_uq_tpu/models/heads.py``. Only the quantile head is
ported so far; it serves the ``quantiles``, ``quantiles_l1`` and ``inn``
uncertainty types, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["QuantileHead", "build_head"]


class QuantileHead(nn.Module):
    """Three conv3x3 heads: lower quantile, prediction, upper quantile.

    The three convs read the same trunk features, so the forward runs them
    as one conv with their output channels concatenated (heads.py:42-65).
    Output: (B, 3, C, H, W) float32, components lower/prediction/upper.
    """

    def __init__(self, n_channels_middle: int = 32, n_channels_out: int = 1):
        super().__init__()
        self.n_channels_out = n_channels_out
        self.lower = nn.Conv2d(n_channels_middle, n_channels_out, 3, padding=1)
        self.prediction = nn.Conv2d(n_channels_middle, n_channels_out, 3, padding=1)
        self.upper = nn.Conv2d(n_channels_middle, n_channels_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = (self.lower, self.prediction, self.upper)
        weight = torch.cat([c.weight for c in convs], dim=0)
        bias = torch.cat([c.bias for c in convs], dim=0)
        y = F.conv2d(x, weight, bias, padding=1)
        b, _, h, w = y.shape
        return y.reshape(b, 3, self.n_channels_out, h, w).float()


def build_head(uncertainty_type: str, n_channels_middle: int, n_channels_out: int) -> nn.Module:
    """Head factory (reference add_uncertainty.py:51-87)."""
    if uncertainty_type in ("quantiles", "quantiles_l1", "inn"):
        return QuantileHead(n_channels_middle, n_channels_out)
    raise NotImplementedError(
        f"uncertainty_type {uncertainty_type!r} is not yet ported"
    )
