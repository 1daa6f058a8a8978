"""RCPS calibration: loss tables on the device, λ̂ selection on the host.

Counterpart of ``im2im_uq_tpu/calibration/rcps.py``; see that module for the
reference semantics, which are kept exactly:

- the λ grid descends; the table is evaluated at λ − dλ, computed in
  float64 and only then cast to float32, while the column is tagged λ;
- λ̂ starts at λ_max + dλ − 1e−9 and is set to the first λ from above where
  R̂ ≥ α or the upper bound exceeds α; the columns below the stop are zero;
- ``evaluate_from_loss_table`` accepts the first λ with HB⁺ ≤ δ, and
  HB(0) = 1 rejects an R̂ of exactly 0.

The bounds are the port's copy of the JAX package's host code
(``calibration/bounds.py``).
Images arrive NHWC from the dataset and are transposed to NCHW here.

Over a ``mesh`` of several ranks (``parallel/mesh.py``) the batch size is
rounded up to a multiple of the ranks, every rank runs the forward and the
loss table's kernel on its slice of each batch, and the slabs come back in
the global batch's order before the mask drops the padding, so that every
rank holds the one-device table and selects the same λ̂.
:func:`compute_risks_device` sums each λ's losses and the count on each
rank and over the ranks, and only the sums reach the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from im2im_uq_tpu_torch.calibration.bounds import HB_mu_plus, WSR_mu_plus
from im2im_uq_tpu_torch.data.core import iterate_batches
from im2im_uq_tpu_torch.models.assembly import UQState, nchw_from_nhwc
from im2im_uq_tpu_torch.ops import sets as set_ops
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "calibrate_model",
    "compute_loss_table",
    "compute_risks_device",
    "default_table_method",
    "evaluate_from_loss_table",
    "evaluate_from_loss_table_fast",
    "hb_acceptance_threshold",
    "lambda_grid",
    "rcps_loss_fn_name",
]


def lambda_grid(config: dict) -> np.ndarray:
    """float64 linspace λ grid (calibrate_model.py:97-100)."""
    if config["uncertainty_type"] == "softmax":
        lo, hi = config["minimum_lambda_softmax"], config["maximum_lambda_softmax"]
    else:
        lo, hi = config["minimum_lambda"], config["maximum_lambda"]
    return np.linspace(lo, hi, config["num_lambdas"], dtype=np.float64)


def rcps_loss_fn_name(config: dict) -> str:
    """Registry check; only 'fraction_missed' exists (calibrate_model.py:82-87)."""
    name = config["rcps_loss"]
    if name != "fraction_missed":
        raise NotImplementedError(f"unknown rcps loss {name!r}")
    return name


def default_table_method(config: Optional[dict], device: torch.device) -> str:
    """The config's ``loss_table_method`` if set; else the loss-table kernel
    K2 ("pallas", the JAX package's name for it) on CUDA, "direct" on the CPU."""
    if config and config.get("loss_table_method"):
        return config["loss_table_method"]
    return "pallas" if torch.device(device).type == "cuda" else "direct"


def _slabs(uq_state: UQState, dataset, lam_values: np.ndarray, batch_size: int,
           mesh: Optional[Mesh], method: str):
    """Per batch: (this rank's (B/ranks, L) slab of fraction missed at the λ
    values, its mask as a device tensor, the global batch's host mask)."""
    device = uq_state.device
    lam = torch.from_numpy(np.asarray(lam_values, np.float64).astype(np.float32)).to(device)
    batch_size = mesh_lib.mesh_batch_size(batch_size, mesh)
    with torch.inference_mode():
        for x, y, mask in iterate_batches(dataset, batch_size, shuffle=False):
            xs, ys, ms = mesh_lib.put_batch(mesh, x, y, mask)
            out = uq_state.forward(nchw_from_nhwc(xs, device))
            params = uq_state.interval_params(out)
            slab = set_ops.rcps_loss_table(params, nchw_from_nhwc(ys, device), lam, method=method)
            yield slab, torch.from_numpy(np.asarray(ms, np.float32)).to(device), mask


def compute_loss_table(
    uq_state: UQState,
    dataset,
    lam_values: np.ndarray,
    batch_size: int = 64,
    mesh: Optional[Mesh] = None,
    method: str = "direct",
) -> np.ndarray:
    """(N, L) fraction-missed table for ``dataset`` at the given λ values.

    Batches are fixed-shape; the padded rows of the last one are dropped
    by the batch mask. Over a ``mesh`` every rank gets the whole table.
    """
    mesh_lib.check_mesh(mesh)
    rows = []
    for slab, _, mask in _slabs(uq_state, dataset, lam_values, batch_size, mesh, method):
        rows.append(mesh_lib.fetch(mesh, slab).cpu().numpy()[mask.astype(bool)])
    return np.concatenate(rows, axis=0)


def compute_risks_device(
    uq_state: UQState,
    dataset,
    lam_values: np.ndarray,
    batch_size: int = 64,
    mesh: Optional[Mesh] = None,
    method: str = "direct",
) -> np.ndarray:
    """(L,) empirical risks R̂ at ``lam_values``, reduced on the device.

    Each batch's masked per-λ sums and its count of real examples are taken
    on the device (over a ``mesh``, on each rank's slice and then summed
    over the ranks), and only those L + 1 numbers reach the host, where
    they accumulate in float64, as the JAX package's
    ``compute_risks_device``. To replicate ``calibrate_model``'s stopping
    rule with it, pass ``lambda_grid(config) − dλ``, not the raw grid.
    """
    mesh_lib.check_mesh(mesh)
    total = np.zeros(len(lam_values), np.float64)
    count = 0.0
    for slab, m, _ in _slabs(uq_state, dataset, lam_values, batch_size, mesh, method):
        sums = torch.cat([(slab * m[:, None]).sum(0), m.sum()[None]])
        if mesh_lib.spans(mesh):
            sums = mesh.all_reduce(sums)
        sums = sums.cpu().numpy()
        total += np.asarray(sums[:-1], np.float64)
        count += float(sums[-1])
    if count == 0:
        raise ValueError("compute_risks_device: dataset produced no examples")
    return total / count


def calibrate_model(
    uq_state: UQState,
    dataset,
    config: dict,
    mesh: Optional[Mesh] = None,
    batch_size: Optional[int] = None,
    method: Optional[str] = None,
) -> tuple[UQState, np.ndarray]:
    """RCPS calibration → (calibrated UQState, (N, num_lambdas) table); over
    a ``mesh`` the same table and λ̂ on every rank."""
    method = method or default_table_method(config, uq_state.device)
    alpha, delta = config["alpha"], config["delta"]
    lambdas = lambda_grid(config)
    rcps_loss_fn_name(config)
    dlambda = lambdas[1] - lambdas[0]
    uq_state = uq_state.set_lhat(float(lambdas[-1] + dlambda - 1e-9))

    bs = batch_size or config.get("batch_size", 64)
    table = compute_loss_table(
        uq_state, dataset, lambdas - dlambda, batch_size=bs, mesh=mesh, method=method
    )
    n = table.shape[0]
    bound = config.get("bound", "hb")

    def ucb(j: int, rhat: float) -> float:
        if bound == "wsr":
            return WSR_mu_plus(table[:, j], delta)
        if bound == "hb":
            return HB_mu_plus(rhat, n, delta)
        raise NotImplementedError(f"unknown bound {bound!r}")

    stop_j = None
    for j in range(len(lambdas) - 1, -1, -1):
        rhat = float(table[:, j].mean())
        if rhat >= alpha or ucb(j, rhat) > alpha:
            uq_state = uq_state.set_lhat(float(lambdas[j]))
            stop_j = j
            print(f"Model's lhat set to {uq_state.lhat}")
            break

    calib_loss_table = table.copy()
    if stop_j is not None and stop_j > 0:
        # the reference stops filling once it breaks; earlier columns are zero
        calib_loss_table[:, :stop_j] = 0.0
    return uq_state, calib_loss_table


def _resplit_trial(loss_table: np.ndarray, n: int, rng: Optional[np.random.RandomState]):
    """One random calib/val re-split → (calib-half column risks, val half)."""
    rng = rng or np.random
    perm = rng.permutation(loss_table.shape[0])
    shuffled = loss_table[perm]
    calib, val = shuffled[:n], shuffled[n:]
    return calib.mean(axis=0), val


def evaluate_from_loss_table(
    loss_table: np.ndarray,
    n: int,
    alpha: float,
    delta: float,
    rng: Optional[np.random.RandomState] = None,
) -> float:
    """One re-split trial: λ̂ on the calib half via HB, the val half's risk
    at λ̂ (calibrate_model.py:62-74). HB is evaluated in grid order and
    stops at the first accepted λ."""
    rhats, val = _resplit_trial(loss_table, n, rng)
    idx = 0  # the reference falls back to 0 when nothing is accepted
    for j, rhat in enumerate(rhats):
        if HB_mu_plus(float(rhat), n, delta) <= delta:
            idx = j
            break
    else:
        print("No rejections made!")
    return float(val[:, idx].mean())


@functools.lru_cache(maxsize=64)
def hb_acceptance_threshold(n: int, delta: float) -> float:
    """Largest empirical risk whose HB upper bound is ≤ δ, by bisection.

    HB⁺ is nondecreasing in the empirical risk, so the per-column test
    ``HB_mu_plus(rhat) <= delta`` is ``0 < rhat <= threshold``; exact 0 is
    rejected because HB(0) = 1. Returns -inf when no positive risk passes.
    """
    lo = 1e-12  # a tiny positive risk (exact 0 is always rejected)
    if HB_mu_plus(lo, n, delta) > delta:
        return float("-inf")
    hi = 1.0
    if HB_mu_plus(hi, n, delta) <= delta:
        return hi
    while True:
        mid = 0.5 * (lo + hi)
        if mid <= lo or mid >= hi:  # adjacent floats: converged exactly
            return lo
        if HB_mu_plus(mid, n, delta) <= delta:
            lo = mid
        else:
            hi = mid


def evaluate_from_loss_table_fast(
    loss_table: np.ndarray,
    n: int,
    alpha: float,
    delta: float,
    rng: Optional[np.random.RandomState] = None,
) -> float:
    """``evaluate_from_loss_table`` with the HB root-finds replaced by one
    cached threshold; same trial semantics and rng draw order."""
    rhats, val = _resplit_trial(loss_table, n, rng)
    accepted = np.nonzero((rhats > 0.0) & (rhats <= hb_acceptance_threshold(n, delta)))[0]
    if accepted.size:
        idx = int(accepted[0])
    else:
        print("No rejections made!")
        idx = 0
    return float(val[:, idx].mean())
