"""Evaluation engine: validation images, validation loss tables.

Counterpart of ``im2im_uq_tpu/training/evaluate.py``. The loss table and
the metric sweep live in ``calibration/{rcps,metrics}.py``; this module adds
the validation table at the unshifted λ grid and the image panels of the
router. Arrays handed back to the caller are NHWC numpy, as the JAX
package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from im2im_uq_tpu_torch.calibration.metrics import eval_set_metrics  # re-export  # noqa: F401
from im2im_uq_tpu_torch.calibration.rcps import compute_loss_table, default_table_method, lambda_grid
from im2im_uq_tpu_torch.models.assembly import UQState, nchw_from_nhwc
from im2im_uq_tpu_torch.training.train import eval_net  # re-export  # noqa: F401
from im2im_uq_tpu_torch.utils.logging import to_uint8_image

__all__ = ["default_lambda", "eval_net", "eval_set_metrics", "get_images", "get_loss_table"]


def default_lambda(uq_state: UQState, config: dict) -> float:
    """λ for renders: λ̂ once calibrated, else 1.0 (0.99 for softmax)."""
    if uq_state.lhat is not None:
        return uq_state.lhat
    return 0.99 if config["uncertainty_type"] == "softmax" else 1.0


def get_loss_table(
    uq_state: UQState, dataset, config: dict, mesh=None, method: Optional[str] = None
) -> np.ndarray:
    """(N, num_lambdas) fraction-missed table at the *unshifted* λ grid.

    The validation table is evaluated at λ itself, unlike calibration's
    λ − dλ. On a CUDA model the default method is the loss-table kernel K2.
    Over a ``mesh`` every rank gets the whole table.
    """
    return compute_loss_table(
        uq_state,
        dataset,
        lambda_grid(config),
        batch_size=config.get("batch_size", 64),
        mesh=mesh,
        method=method or default_table_method(config, uq_state.device),
    )


def _nhwc(t) -> np.ndarray:
    """(C, H, W) tensor → (H, W, C) numpy."""
    return t.permute(1, 2, 0).cpu().numpy()


def get_images(
    uq_state: UQState,
    dataset,
    indices,
    config: dict,
    lam: Optional[float] = None,
) -> dict:
    """Prediction-set panels for the given example indices.

    Returns the raw arrays (inputs / gt / predictions / lower_edge /
    upper_edge, each a list of (H, W, C) arrays) and uint8 renders: input,
    lower / prediction / upper edges, ground truth, and the lower / upper
    interval-length maps normalised by the prediction's range.
    """
    lam = default_lambda(uq_state, config) if lam is None else lam
    if not hasattr(dataset, "__getitem__"):
        # an iterable dataset: materialise the first examples, at most as
        # many as the stream holds
        it = iter(dataset)
        examples = []
        for _ in range(max(indices) + 1):
            try:
                examples.append(next(it))
            except StopIteration:
                break
        if hasattr(dataset, "reset"):
            dataset.reset()
        dataset = examples
    indices = [i for i in indices if i < len(dataset)]
    device = uq_state.device
    inputs, gts, lowers, preds, uppers = [], [], [], [], []
    for i in indices:
        x, y = dataset[i]
        lower, pred, upper = uq_state.nested_sets(nchw_from_nhwc(np.asarray(x)[None], device), lam=lam)
        inputs.append(np.asarray(x))
        gts.append(np.asarray(y))
        lowers.append(_nhwc(lower[0]))
        preds.append(_nhwc(pred[0]))
        uppers.append(_nhwc(upper[0]))

    raw = {
        "inputs": inputs,
        "gt": gts,
        "predictions": preds,
        "lower_edge": lowers,
        "upper_edge": uppers,
    }
    # multi-channel inputs render channel 0
    render_in = [x[..., :1] for x in inputs]
    panels = {
        "examples_input": [to_uint8_image(x) for x in render_in],
        "examples_lower_edge": [to_uint8_image(v) for v in lowers],
        "examples_prediction": [to_uint8_image(v) for v in preds],
        "examples_upper_edge": [to_uint8_image(v) for v in uppers],
        "examples_ground_truth": [to_uint8_image(v) for v in gts],
    }
    ll, ul = [], []
    for lo, p, hi in zip(lowers, preds, uppers):
        span = max(float(p.max() - p.min()), 1e-12)
        ll.append(to_uint8_image((p - lo) / span, self_normalize=False))
        ul.append(to_uint8_image((hi - p) / span, self_normalize=False))
    panels["examples_lower_length"] = ll
    panels["examples_upper_length"] = ul
    return {"raw": raw, "panels": panels}
