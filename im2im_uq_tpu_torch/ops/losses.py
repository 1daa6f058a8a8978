"""Loss primitives for the uncertainty heads, in PyTorch ops.

Counterpart of ``im2im_uq_tpu/ops/losses.py``: pure functions of tensors,
with the same formulas, the same elementwise maps and the same per-example
reduction. The class axis of the softmax cross-entropy is an argument, as
there; the callers pass NCHW maps.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch.ops.constants import device_constants

__all__ = [
    "absolute",
    "ae_elem",
    "bucketize_targets",
    "gaussian_nll",
    "gaussian_nll_elem",
    "interval_score",
    "interval_score_elem",
    "l1",
    "mse",
    "per_example_mean",
    "pinball",
    "pinball_elem",
    "se_elem",
    "softmax_cross_entropy",
    "softmax_cross_entropy_elem",
]


class _Absolute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x| with the derivative of ``jnp.abs``: +1 at ±0 (its JVP is
    ``where(x >= 0, g, −g)``), where ``Tensor.abs`` has 0. The values are
    those of ``x.abs()``."""
    return _Absolute.apply(x)


def per_example_mean(elem: torch.Tensor) -> torch.Tensor:
    """Reduce an elementwise loss map over all non-batch dims → (B,)."""
    return elem.reshape(elem.shape[0], -1).mean(dim=1)


def pinball_elem(pred: torch.Tensor, target: torch.Tensor, quantile: float) -> torch.Tensor:
    """Elementwise pinball loss: under-prediction weighted by ``quantile``,
    over-prediction by ``1 - quantile``; exact zeros contribute nothing."""
    err = pred - target
    return torch.where(err < 0, quantile * (-err), (1.0 - quantile) * err)


def pinball(pred: torch.Tensor, target: torch.Tensor, quantile: float) -> torch.Tensor:
    return pinball_elem(pred, target, quantile).mean()


def se_elem(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return d * d


def ae_elem(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return absolute(pred - target)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return se_elem(pred, target).mean()


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ae_elem(pred, target).mean()


def gaussian_nll_elem(
    mean: torch.Tensor, target: torch.Tensor, var: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Elementwise heteroscedastic Gaussian NLL, as torch.nn.GaussianNLLLoss
    (full=False, eps=1e-6): 0.5·(log max(var, eps) + (target − mean)²/max(var, eps)).

    The max is ``torch.maximum`` against a tensor, whose gradient at a tie
    var == eps is 0.5, as ``jnp.maximum``'s; ``torch.clamp``'s is 1."""
    var = torch.maximum(var, var.new_tensor(eps))
    d = target - mean
    return 0.5 * (torch.log(var) + d * d / var)


def gaussian_nll(
    mean: torch.Tensor, target: torch.Tensor, var: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    return gaussian_nll_elem(mean, target, var, eps).mean()


def interval_score_elem(
    lower: torch.Tensor, upper: torch.Tensor, target: torch.Tensor, beta: float
) -> torch.Tensor:
    """relu(target − upper)² + relu(lower − target)² + beta·|upper − lower|."""
    over = F.relu(target - upper)
    under = F.relu(lower - target)
    return over * over + under * under + beta * absolute(upper - lower)


def interval_score(
    lower: torch.Tensor, upper: torch.Tensor, target: torch.Tensor, beta: float
) -> torch.Tensor:
    return interval_score_elem(lower, upper, target, beta).mean()


def bucketize_targets(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Bin [0, 1]-valued targets into ``num_classes`` classes (int64).

    Boundaries are the f32 values of ``jnp.linspace(0, 1, S)``: i times the
    f32 reciprocal of S − 1 (XLA's lowering of the division by a constant),
    with the last one exactly 1. ``right=False`` is searchsorted's
    side='left'; indices ≥ S are clamped to S − 1.
    """
    classes = _class_bounds(num_classes, target.device, target.dtype)
    idx = torch.bucketize(target, classes, right=False)
    return torch.clamp(idx, max=num_classes - 1)


def _class_bounds(num_classes: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`bucketize_targets`' boundaries on ``device``, kept per count
    (``ops/constants.py``)."""
    def build():
        step = np.float32(1.0) / np.float32(max(num_classes - 1, 1))
        bounds = np.arange(num_classes, dtype=np.float32) * step
        bounds[-1:] = 1.0 if num_classes > 1 else 0.0
        return (torch.from_numpy(bounds).to(device=device, dtype=dtype),)

    return device_constants(("class_bounds", num_classes, device, dtype), (num_classes,),
                            build)[0]


def softmax_cross_entropy_elem(
    logits: torch.Tensor, labels: torch.Tensor, dim: int = 1
) -> torch.Tensor:
    """Elementwise cross-entropy of integer ``labels`` under ``logits``; the
    class axis ``dim`` is consumed and the result has the labels' shape."""
    logp = F.log_softmax(logits, dim=dim)
    return -torch.gather(logp, dim, labels.long().unsqueeze(dim)).squeeze(dim)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return softmax_cross_entropy_elem(logits, labels, dim).mean()
