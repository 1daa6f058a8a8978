"""RCPS evaluation metrics: risk, sizes, Spearman, stratified risk, MSE,
spatial miscoverage.

Counterpart of ``im2im_uq_tpu/calibration/metrics.py``. The forward and the
set construction run on the model's device, one batch at a time; the
per-image reductions and every random draw run on the host in the JAX
package's order:

- the per-image fraction missed at λ̂;
- one ``rng.choice`` per batch: one uniformly random pixel per image of the
  size map, flattened in NHWC order as in the JAX package;
- after all batches, the U(0, 1)·1e−6 tie-break jitter over all sizes;
- Spearman's rank correlation of |residual| and size at those pixels, and
  the MSE of those residuals;
- the per-pixel miss map averaged over images and channels;
- the risk in the size quartiles, with ``searchsorted(side="left") − 1``
  buckets (torch.bucketize(right=False)).

Over a ``mesh`` of several ranks each rank runs the forward and the sets
on its slice of each batch (the batch size rounded up to a multiple of the
ranks), and the per-image results are gathered in the global batch's order
before any draw, so that ``rng`` is drawn from in the one-device order and
the miss map is summed over the global batch; every rank returns the same
metrics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.stats import spearmanr

from im2im_uq_tpu_torch.calibration.rcps import compute_loss_table
from im2im_uq_tpu_torch.data.core import iterate_batches
from im2im_uq_tpu_torch.models.assembly import UQState, nchw_from_nhwc
from im2im_uq_tpu_torch.ops import sets as set_ops
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.parallel.mesh import Mesh

__all__ = ["RCPSMetrics", "eval_risk_only", "eval_set_metrics"]


class RCPSMetrics(NamedTuple):
    risk: float  # mean fraction missed at λ̂
    losses: np.ndarray  # (N,) per-image fraction missed
    sizes: np.ndarray  # (N,) sampled interval sizes (jittered)
    spearman: float  # rank corr(residual, size) at the sampled pixels
    stratified_risks: np.ndarray  # (4,) risk per size quartile
    mse: float  # mean squared sampled residual
    spatial_miscoverage: np.ndarray  # (H, W) mean miss map


def _batch_metrics(uq_state: UQState, x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor,
                   mesh: Optional[Mesh]):
    """(losses (B,), sizes, residuals, miss (B, H, W, C)) of the global
    batch as numpy, from this rank's slice (x, y)."""
    lower, pred, upper = set_ops.nested_sets_from_output(
        uq_state.forward(x), lam, uq_state.uncertainty_type
    )
    losses = set_ops.fraction_missed(lower, upper, y)
    maps = (upper - lower, (y - pred).abs(), set_ops.miss_map(lower, upper, y))
    return tuple(mesh_lib.fetch(mesh, t).cpu().numpy()
                 for t in (losses, *(m.permute(0, 2, 3, 1) for m in maps)))


def eval_set_metrics(
    uq_state: UQState,
    dataset,
    config: dict,
    mesh: Optional[Mesh] = None,
    batch_size: Optional[int] = None,
    lam: Optional[float] = None,
    rng: Optional[np.random.RandomState] = None,
) -> RCPSMetrics:
    """Full metric sweep over ``dataset`` at λ̂ (or an explicit ``lam``);
    random draws come from ``rng``, else from the global ``np.random``."""
    mesh_lib.check_mesh(mesh)
    if lam is None:
        if uq_state.lhat is None:
            raise ValueError("calibrate first or pass an explicit lam")
        lam = uq_state.lhat
    rng = rng or np.random
    bs = mesh_lib.mesh_batch_size(batch_size or config.get("batch_size", 64), mesh)
    device = uq_state.device
    lam_t = torch.tensor(lam, dtype=torch.float32, device=device)

    losses_l, sizes_l, resid_l, spatial_sum, n_seen = [], [], [], None, 0
    with torch.inference_mode():
        for x, y, mask in iterate_batches(dataset, bs, shuffle=False):
            xs, ys = mesh_lib.put_batch(mesh, x, y)
            losses, sizes, residuals, miss = _batch_metrics(
                uq_state, nchw_from_nhwc(xs, device), nchw_from_nhwc(ys, device), lam_t, mesh
            )
            real = mask.astype(bool)
            losses, sizes, residuals, miss = losses[real], sizes[real], residuals[real], miss[real]
            b = losses.shape[0]
            flat_sizes = sizes.reshape(b, -1)
            flat_resid = residuals.reshape(b, -1)
            pix = rng.choice(flat_sizes.shape[1], size=b)  # one random pixel per image
            losses_l.append(losses)
            sizes_l.append(flat_sizes[np.arange(b), pix])
            resid_l.append(flat_resid[np.arange(b), pix])
            batch_spatial = miss.sum(axis=0).mean(axis=-1)  # (H, W), summed over the batch
            spatial_sum = batch_spatial if spatial_sum is None else spatial_sum + batch_spatial
            n_seen += b

    losses = np.concatenate(losses_l)
    sizes = np.concatenate(sizes_l)
    residuals = np.concatenate(resid_l)
    sizes = sizes + rng.random_sample(sizes.shape) * 1e-6  # tie-break jitter
    spearman = float(spearmanr(residuals, sizes)[0])
    mse = float(np.mean(residuals * residuals))
    spatial = spatial_sum / n_seen

    size_bins = np.array(
        [0.0, np.quantile(sizes, 0.25), np.quantile(sizes, 0.5), np.quantile(sizes, 0.75)]
    )
    # torch.bucketize(right=False) == searchsorted side='left'; then −1
    buckets = np.searchsorted(size_bins, sizes, side="left") - 1
    stratified = np.array(
        [losses[buckets == b].mean() if np.any(buckets == b) else np.nan for b in range(4)]
    )
    return RCPSMetrics(
        risk=float(losses.mean()),
        losses=losses,
        sizes=sizes,
        spearman=spearman,
        stratified_risks=stratified,
        mse=mse,
        spatial_miscoverage=spatial,
    )


def eval_risk_only(uq_state: UQState, dataset, config: dict,
                   mesh: Optional[Mesh] = None) -> float:
    """Cheap risk check at λ̂ (no sampling or ranking)."""
    if uq_state.lhat is None:
        raise ValueError("calibrate first or pass an explicit lam")
    table = compute_loss_table(
        uq_state, dataset, np.array([uq_state.lhat], dtype=np.float64),
        batch_size=config.get("batch_size", 64), mesh=mesh,
    )
    return float(table.mean())
