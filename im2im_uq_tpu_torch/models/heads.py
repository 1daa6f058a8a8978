"""Uncertainty heads, NCHW.

Counterpart of ``im2im_uq_tpu/models/heads.py``: the modules of the seven
uncertainty types and their per-example training losses. The quantile head
serves ``quantiles``, ``quantiles_l1`` and ``inn``, the residual head both
``residual_magnitude`` types, as in the JAX package. A head's output is
(B, K, C, H, W), where the JAX one is (B, K, H, W, C); ``pred[:, k]`` is one
component either way, and the per-example means reduce over all of an
example's pixels. The softmax head's K is its ``num_softmax`` classes.
Each head runs its sibling convs, which read the same trunk features, as
one conv over their concatenated weights and biases (``heads.py:42-65``),
in the compute dtype ``dtype``; its output is float32 (``heads.py:87, 104,
124, 149``), so the losses and the calibration see float32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from im2im_uq_tpu_torch.models.unet import compute_cast
from im2im_uq_tpu_torch.ops import losses as L
from im2im_uq_tpu_torch.parallel import spatial

__all__ = [
    "HEAD_BUILDERS",
    "HEAD_LOSS_PE_FNS",
    "GaussianHead",
    "QuantileHead",
    "ResidualMagnitudeHead",
    "SoftmaxHead",
    "build_head",
    "gaussian_loss_pe",
    "head_loss_fn",
    "head_loss_pe_fn",
    "inn_loss_pe",
    "quantile_l1_loss_pe",
    "quantile_loss_pe",
    "residual_magnitude_l1_loss_pe",
    "residual_magnitude_loss_pe",
    "softmax_loss_pe",
]


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def _fused_conv3x3(x: torch.Tensor, convs, dtype: torch.dtype) -> torch.Tensor:
    """The sibling convs as one conv in ``dtype``: their outputs
    concatenated along the channels, in the order given. A height-sharded
    forward runs it on the rank's rows plus halo rows
    (``parallel/spatial.halo_conv``)."""
    weight = compute_cast(torch.cat([c.weight for c in convs], dim=0), dtype)
    bias = compute_cast(torch.cat([c.bias for c in convs], dim=0), dtype)
    return spatial.halo_conv(lambda t: F.conv2d(compute_cast(t, dtype), weight, bias, padding=1), x)


def _components(y: torch.Tensor, k: int) -> torch.Tensor:
    """(B, K·C, H, W) → (B, K, C, H, W)."""
    b, _, h, w = y.shape
    return y.reshape(b, k, -1, h, w)


class QuantileHead(nn.Module):
    """Three conv3x3 heads: lower quantile, prediction, upper quantile.
    Output: (B, 3, C, H, W) float32, components lower/prediction/upper."""

    def __init__(self, n_channels_middle: int = 32, n_channels_out: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lower = _conv3x3(n_channels_middle, n_channels_out)
        self.prediction = _conv3x3(n_channels_middle, n_channels_out)
        self.upper = _conv3x3(n_channels_middle, n_channels_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _fused_conv3x3(x, (self.lower, self.prediction, self.upper), self.dtype)
        return _components(y, 3).float()


class GaussianHead(nn.Module):
    """Mean and ReLU-rectified variance (``heads.py:90``).
    Output: (B, 2, C, H, W) float32, components mean/variance."""

    def __init__(self, n_channels_middle: int = 32, n_channels_out: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mean = _conv3x3(n_channels_middle, n_channels_out)
        self.variance = _conv3x3(n_channels_middle, n_channels_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _components(_fused_conv3x3(x, (self.mean, self.variance), self.dtype), 2)
        return torch.stack([y[:, 0], F.relu(y[:, 1])], dim=1).float()


class ResidualMagnitudeHead(nn.Module):
    """Prediction and |residual magnitude| (``heads.py:107``), the |·| with
    ``jnp.abs``'s derivative (``ops/losses.absolute``).
    Output: (B, 2, C, H, W) float32, components prediction/magnitude."""

    def __init__(self, n_channels_middle: int = 32, n_channels_out: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.prediction = _conv3x3(n_channels_middle, n_channels_out)
        self.residual_magnitude = _conv3x3(n_channels_middle, n_channels_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _components(_fused_conv3x3(x, (self.prediction, self.residual_magnitude), self.dtype), 2)
        return torch.stack([y[:, 0], L.absolute(y[:, 1])], dim=1).float()


class SoftmaxHead(nn.Module):
    """An S-way classifier over binned [0, 1] values per target channel
    (``heads.py:127``): one conv of ``num_softmax`` outputs per channel, in
    ``output_layers`` (the reference's layout, which the JAX package's
    export writes for its ``out{c}`` convs). Output: (B, S, C, H, W)
    float32 logits; the JAX head's are (B, S, H, W, C)."""

    def __init__(self, num_softmax: int, n_channels_middle: int = 32, n_channels_out: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.output_layers = nn.ModuleList(
            _conv3x3(n_channels_middle, num_softmax) for _ in range(n_channels_out)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # channel-major concatenation: (B, C·S, H, W) → (B, C, S, H, W)
        y = _components(_fused_conv3x3(x, self.output_layers, self.dtype), len(self.output_layers))
        return y.transpose(1, 2).float()


HEAD_BUILDERS: dict[str, Callable[[int, int, dict, torch.dtype], nn.Module]] = {
    "quantiles": lambda mid, out, p, dt: QuantileHead(mid, out, dt),
    "quantiles_l1": lambda mid, out, p, dt: QuantileHead(mid, out, dt),
    "inn": lambda mid, out, p, dt: QuantileHead(mid, out, dt),
    "gaussian": lambda mid, out, p, dt: GaussianHead(mid, out, dt),
    "residual_magnitude": lambda mid, out, p, dt: ResidualMagnitudeHead(mid, out, dt),
    "residual_magnitude_l1": lambda mid, out, p, dt: ResidualMagnitudeHead(mid, out, dt),
    "softmax": lambda mid, out, p, dt: SoftmaxHead(int(p["num_softmax"]), mid, out, dt),
}


def build_head(
    uncertainty_type: str, n_channels_middle: int, n_channels_out: int, params: dict,
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Head factory (reference add_uncertainty.py:51-87); ``params`` is the
    config, which gives the softmax head its ``num_softmax``; ``dtype`` the
    compute dtype of its convs."""
    try:
        builder = HEAD_BUILDERS[uncertainty_type]
    except KeyError:
        raise NotImplementedError(f"unknown uncertainty_type {uncertainty_type!r}") from None
    return builder(n_channels_middle, n_channels_out, params, dtype)


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


def gaussian_loss_pe(pred: torch.Tensor, target: torch.Tensor, params: dict) -> torch.Tensor:
    """Heteroscedastic Gaussian NLL of (mean, variance), per example (B,)."""
    return _pe(L.gaussian_nll_elem(pred[:, 0], target, pred[:, 1]))


def residual_magnitude_loss_pe(
    pred: torch.Tensor, target: torch.Tensor, params: dict
) -> torch.Tensor:
    """MSE(centre) + MSE(magnitude against |error|), per example (B,). The
    gradient flows through |target − centre| too (no detach), as in the
    JAX package and the reference."""
    return _pe(L.se_elem(pred[:, 0], target)) + _pe(
        L.se_elem(pred[:, 1], L.absolute(target - pred[:, 0]))
    )


def residual_magnitude_l1_loss_pe(
    pred: torch.Tensor, target: torch.Tensor, params: dict
) -> torch.Tensor:
    """Same as :func:`residual_magnitude_loss_pe` with an L1 centre term."""
    return _pe(L.ae_elem(pred[:, 0], target)) + _pe(
        L.se_elem(pred[:, 1], L.absolute(target - pred[:, 0]))
    )


def softmax_loss_pe(pred: torch.Tensor, target: torch.Tensor, params: dict) -> torch.Tensor:
    """Cross-entropy of the (B, S, C, H, W) logits over bucketized [0, 1]
    targets, per example (B,)."""
    labels = L.bucketize_targets(target, params["num_softmax"])
    return _pe(L.softmax_cross_entropy_elem(pred, labels, dim=1))


HEAD_LOSS_PE_FNS: dict[str, Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]] = {
    "quantiles": quantile_loss_pe,
    "quantiles_l1": quantile_l1_loss_pe,
    "gaussian": gaussian_loss_pe,
    "residual_magnitude": residual_magnitude_loss_pe,
    "residual_magnitude_l1": residual_magnitude_l1_loss_pe,
    "softmax": softmax_loss_pe,
    "inn": inn_loss_pe,
}


def head_loss_pe_fn(uncertainty_type: str):
    """Per-example (B,)-shaped training loss of a head type."""
    try:
        return HEAD_LOSS_PE_FNS[uncertainty_type]
    except KeyError:
        raise NotImplementedError(f"unknown uncertainty_type {uncertainty_type!r}") from None


def head_loss_fn(uncertainty_type: str):
    """Scalar training loss of a head type: the batch mean of
    :func:`head_loss_pe_fn`'s per-example losses."""
    loss_pe = head_loss_pe_fn(uncertainty_type)

    def loss(pred: torch.Tensor, target: torch.Tensor, params: dict) -> torch.Tensor:
        return loss_pe(pred, target, params).mean()

    return loss
