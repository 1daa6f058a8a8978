"""Nested prediction-set algebra, in PyTorch.

Counterpart of ``im2im_uq_tpu/ops/sets.py``; see that module for the
derivations. Every head's set is linear in λ around the point prediction:
lower(λ) = pred − λ·dl and upper(λ) = pred + λ·du, so a head's output is
factored once into :class:`IntervalParams` and the sets at any λ are
elementwise.

Layout: head outputs carry the component axis right after the batch axis,
``(B, K, ...)``; the maps that come out drop it. The functions here are
elementwise or reduce over everything but the batch axis, so they work on
the port's NCHW maps and on the JAX package's NHWC maps alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "COLLAPSE_EPS",
    "INTERVAL_PARAM_FNS",
    "IntervalParams",
    "critical_lambdas",
    "divide_counts",
    "fraction_missed",
    "interval_params",
    "miss_map",
    "nested_sets_from_output",
    "rcps_loss_table",
    "sets_from_params",
]

# Minimum half-width of any prediction set (reference add_uncertainty.py:35-36).
COLLAPSE_EPS = 1e-6
# Pre-scale clamp on quantile/inn raw edges (reference quantile_layer.py:39-40).
_EDGE_EPS = 1e-6


class IntervalParams(NamedTuple):
    """λ-independent per-pixel set geometry: lower(λ) = pred − λ·dl, etc."""

    pred: torch.Tensor
    dl: torch.Tensor  # lower slope, ≥ 0
    du: torch.Tensor  # upper slope, ≥ 0


def _quantile_interval_params(output: torch.Tensor) -> IntervalParams:
    """Three-component heads (quantiles, quantiles_l1, inn): clamp, then scale."""
    lo, pred, hi = output[:, 0], output[:, 1], output[:, 2]
    dl = torch.clamp(pred - lo, min=_EDGE_EPS)
    du = torch.clamp(hi - pred, min=_EDGE_EPS)
    return IntervalParams(pred, dl, du)


def _gaussian_interval_params(output: torch.Tensor) -> IntervalParams:
    """Mean/variance head: symmetric ±λ·σ sets."""
    pred, var = output[:, 0], output[:, 1]
    sigma = torch.sqrt(var)
    return IntervalParams(pred, sigma, sigma)


def _residual_interval_params(output: torch.Tensor) -> IntervalParams:
    """Prediction + |residual| head: ±λ·r sets."""
    pred, r = output[:, 0], output[:, 1]
    return IntervalParams(pred, r, r)


@torch.no_grad()
def _softmax_interval_params(output: torch.Tensor) -> IntervalParams:
    """Per-pixel classifier over S bins of [0, 1], logits (B, S, ...):
    pred = the first argmax bin / S; the raw edges count the bins whose
    cumulative softmax is ≤ 0.05 and ≤ 0.95, over S; an edge equal to pred
    moves out by one bin; the edges are clipped to [0, 1] and the slopes
    are the relu'd distances. No gradient, as the JAX package's
    stop_gradient and the reference's no_grad."""
    inv_s = 1.0 / output.shape[1]
    probs = torch.softmax(output, dim=1)
    cdf = torch.cumsum(probs, dim=1)
    lower_q = (cdf <= 0.05).to(probs.dtype).sum(dim=1) * inv_s
    upper_q = (cdf <= 0.95).to(probs.dtype).sum(dim=1) * inv_s
    pred = torch.argmax(probs, dim=1).to(probs.dtype) * inv_s
    lower_q = torch.where(pred == lower_q, lower_q - inv_s, lower_q).clamp(0.0, 1.0)
    upper_q = torch.where(pred == upper_q, upper_q + inv_s, upper_q).clamp(0.0, 1.0)
    return IntervalParams(pred, torch.relu(pred - lower_q), torch.relu(upper_q - pred))


INTERVAL_PARAM_FNS: dict[str, Callable[[torch.Tensor], IntervalParams]] = {
    "quantiles": _quantile_interval_params,
    "quantiles_l1": _quantile_interval_params,
    "inn": _quantile_interval_params,
    "gaussian": _gaussian_interval_params,
    "residual_magnitude": _residual_interval_params,
    "residual_magnitude_l1": _residual_interval_params,
    "softmax": _softmax_interval_params,
}


def interval_params(output: torch.Tensor, uncertainty_type: str) -> IntervalParams:
    """Factor a head's raw output into λ-independent set geometry."""
    try:
        fn = INTERVAL_PARAM_FNS[uncertainty_type]
    except KeyError:
        raise NotImplementedError(
            f"unknown uncertainty_type {uncertainty_type!r}; "
            f"expected one of {sorted(INTERVAL_PARAM_FNS)}"
        ) from None
    return fn(output)


def sets_from_params(
    params: IntervalParams, lam: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lower, pred, upper) at scale λ, with the global collapse guard:
    lower = min(pred − λ·dl, pred − 1e−6), upper = max(pred + λ·du, pred + 1e−6)."""
    pred, dl, du = params
    lower = torch.minimum(pred - lam * dl, pred - COLLAPSE_EPS)
    upper = torch.maximum(pred + lam * du, pred + COLLAPSE_EPS)
    return lower, pred, upper


def nested_sets_from_output(
    output: torch.Tensor, lam: torch.Tensor | float, uncertainty_type: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-shot (lower, pred, upper) from a head's raw output at scale λ."""
    return sets_from_params(interval_params(output, uncertainty_type), lam)


def miss_map(lower: torch.Tensor, upper: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-pixel miscoverage indicator in {0, 1}: label < lower or label > upper."""
    miss = (lower > label).to(label.dtype) + (upper < label).to(label.dtype)
    return torch.clamp(miss, max=1.0)


def fraction_missed(
    lower: torch.Tensor, upper: torch.Tensor, label: torch.Tensor
) -> torch.Tensor:
    """Per-example fraction of pixels outside [lower, upper] → shape (B,).

    The count of 0/1 values is exact in f32. It is then multiplied by the
    f32 reciprocal of the pixel count, which is how XLA lowers the JAX
    package's ``jnp.mean`` (a true division differs by 1 ulp at some counts).
    """
    m = miss_map(lower, upper, label).reshape(label.shape[0], -1)
    return m.sum(dim=1) * (1.0 / m.shape[1])


def divide_counts(counts: torch.Tensor, num_px: int) -> torch.Tensor:
    """counts / num_px as an IEEE f32 division on every device.

    The divisor is a tensor: with a Python-number divisor, PyTorch's CUDA
    kernel multiplies by the reciprocal instead, which differs by 1 ulp.
    """
    counts = counts.to(torch.float32)
    return counts / torch.full_like(counts, float(num_px))


def critical_lambdas(params: IntervalParams, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel critical λ: the pixel is missed at λ iff λ < crit."""
    pred, dl, du = params
    a = pred - labels
    b = labels - pred
    inf = torch.full_like(pred, float("inf"))
    zero = torch.zeros_like(pred)
    crit_lo = torch.where(a > COLLAPSE_EPS, torch.where(dl > 0, a / dl, inf), zero)
    crit_hi = torch.where(b > COLLAPSE_EPS, torch.where(du > 0, b / du, inf), zero)
    return torch.maximum(crit_lo, crit_hi)


def _loss_table_direct(
    params: IntervalParams, labels: torch.Tensor, lam_grid: torch.Tensor
) -> torch.Tensor:
    """(N, L) table by building the sets at every λ (the reference's math)."""
    cols = []
    for lam in lam_grid:
        lower, _, upper = sets_from_params(params, lam)
        cols.append(fraction_missed(lower, upper, labels))
    return torch.stack(cols, dim=1)


def _loss_table_fast(
    params: IntervalParams, labels: torch.Tensor, lam_grid: torch.Tensor
) -> torch.Tensor:
    """(N, L) table from sorted critical λs: loss(n, j) = mean(crit_n > λ_j)."""
    crit = critical_lambdas(params, labels)
    n = crit.shape[0]
    flat = torch.sort(crit.reshape(n, -1), dim=1).values
    num_px = flat.shape[1]
    covered = torch.searchsorted(
        flat, lam_grid.expand(n, -1).contiguous(), right=True
    )
    return divide_counts(num_px - covered, num_px)


def rcps_loss_table(
    params: IntervalParams,
    labels: torch.Tensor,
    lam_grid,
    method: str = "direct",
) -> torch.Tensor:
    """Full (N, num_lambdas) fraction-missed loss table.

    ``direct`` builds the sets at every λ, ``fast`` uses the critical-λ
    factorization, and ``pallas`` is the loss-table kernel K2
    (``ops/loss_table.py``), which keeps the JAX package's method name.
    """
    pred = params.pred
    lam_grid = torch.as_tensor(lam_grid, dtype=pred.dtype, device=pred.device)
    if method == "direct":
        return _loss_table_direct(params, labels, lam_grid)
    if method == "fast":
        return _loss_table_fast(params, labels, lam_grid)
    if method == "pallas":
        from im2im_uq_tpu_torch.ops.loss_table import loss_table

        n = labels.shape[0]
        maps = (t.reshape(n, -1).to(torch.float32).contiguous()
                for t in (pred, labels, params.dl, params.du))
        return loss_table(*maps, lam_grid.to(torch.float32).contiguous())
    raise ValueError(f"unknown loss-table method {method!r}")
