"""Uncertainty heads, NCHW.

Counterpart of ``im2im_uq_tpu/models/heads.py``. Only the quantile head is
ported so far; it serves the ``quantiles``, ``quantiles_l1`` and ``inn``
uncertainty types, as in the JAX package, and so do the per-example training
losses below. The head's output is (B, K, C, H, W), where the JAX one is
(B, K, H, W, C); ``pred[:, k]`` is one component either way, and the
per-example means reduce over all of an example's pixels.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from im2im_uq_tpu_torch.ops import losses as L

__all__ = [
    "HEAD_LOSS_PE_FNS",
    "QuantileHead",
    "build_head",
    "head_loss_pe_fn",
    "inn_loss_pe",
    "quantile_l1_loss_pe",
    "quantile_loss_pe",
]


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


_pe = L.per_example_mean


def quantile_loss_pe(pred: torch.Tensor, target: torch.Tensor, params: dict) -> torch.Tensor:
    """w_lo·Pinball(q_lo) + w_hi·Pinball(q_hi) + w_mse·MSE, per example (B,)."""
    return (
        params["q_lo_weight"] * _pe(L.pinball_elem(pred[:, 0], target, params["q_lo"]))
        + params["q_hi_weight"] * _pe(L.pinball_elem(pred[:, 2], target, params["q_hi"]))
        + params["mse_weight"] * _pe(L.se_elem(pred[:, 1], target))
    )


def quantile_l1_loss_pe(pred: torch.Tensor, target: torch.Tensor, params: dict) -> torch.Tensor:
    """Same as :func:`quantile_loss_pe` with an L1 centre term."""
    return (
        params["q_lo_weight"] * _pe(L.pinball_elem(pred[:, 0], target, params["q_lo"]))
        + params["q_hi_weight"] * _pe(L.pinball_elem(pred[:, 2], target, params["q_hi"]))
        + params["mse_weight"] * _pe(L.ae_elem(pred[:, 1], target))
    )


def inn_loss_pe(pred: torch.Tensor, target: torch.Tensor, params: dict) -> torch.Tensor:
    """MSE(centre) + interval score on (lower, upper), per example (B,)."""
    return _pe(L.se_elem(pred[:, 1], target)) + _pe(
        L.interval_score_elem(pred[:, 0], pred[:, 2], target, params["beta"])
    )


HEAD_LOSS_PE_FNS: dict[str, Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]] = {
    "quantiles": quantile_loss_pe,
    "quantiles_l1": quantile_l1_loss_pe,
    "inn": inn_loss_pe,
}


def head_loss_pe_fn(uncertainty_type: str):
    """Per-example (B,)-shaped training loss of a head type."""
    try:
        return HEAD_LOSS_PE_FNS[uncertainty_type]
    except KeyError:
        raise NotImplementedError(
            f"the loss of uncertainty_type {uncertainty_type!r} is not yet ported"
        ) from None
