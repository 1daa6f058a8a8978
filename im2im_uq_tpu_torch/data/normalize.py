"""Dataset normalization: streaming statistics with a pickle-compatible cache.

Counterpart of the reference's normalization utils (reference:
core/datasets/utils.py:8-103 — eager ``normalize``, streaming
``normalize_dataset`` with Welford ``RunningStats`` and a
``norm_params.pickle`` cache under ``dataset.cache_path``). Keeps the same
norm-params dict keys (input_max/input_min/input_mean/input_std and the
output_* counterparts) so configs and downstream rescaling stay drop-in.

The port's copy of ``im2im_uq_tpu/data/normalize.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

__all__ = ["normalize_array", "apply_normalization", "compute_norm_params", "normalize_dataset", "RunningMoments"]


def normalize_array(x: np.ndarray, kind: str, per_pixel: bool, tag: str):
    """Eager whole-tensor normalization (reference datasets/utils.py:8-33).

    ``kind`` ∈ {'standard', 'min-max'}; per_pixel computes the statistic per
    spatial location over the leading (batch) axis. Returns (normalized,
    params dict keyed like the reference: mean_<tag>/std_<tag> or
    max_<tag>/min_<tag>).
    """
    if kind == "standard":
        if per_pixel:
            mean, std = x.mean(axis=0, keepdims=True), x.std(axis=0, keepdims=True)
        else:
            mean, std = x.mean(), x.std()
        return (x - mean) / std, {f"mean_{tag}": mean, f"std_{tag}": std}
    if kind == "min-max":
        if per_pixel:
            mx, mn = x.max(axis=0, keepdims=True), x.min(axis=0, keepdims=True)
        else:
            mx, mn = x.max(), x.min()
        return (x - mn) / (mx - mn), {f"max_{tag}": mx, f"min_{tag}": mn}
    raise NotImplementedError(f"unknown normalization {kind!r}")


def apply_normalization(x: np.ndarray, kind: str, params: dict, tag: str) -> np.ndarray:
    """Apply dataset-level normalization from a norm-params dict.

    Mirrors the FastMRI dataset's post-hoc per-item normalization using the
    global dataset statistics (reference: core/datasets/fastmri/
    FastMRIDataset.py:131-163): 'standard' → (x − mean)/std,
    'min-max' → (x − min)/(max − min).
    """
    if kind in (None, "none"):
        return x
    if kind == "standard":
        return (x - params[f"{tag}_mean"]) / params[f"{tag}_std"]
    if kind == "min-max":
        return (x - params[f"{tag}_min"]) / (params[f"{tag}_max"] - params[f"{tag}_min"])
    raise NotImplementedError(f"unknown normalization {kind!r}")


class RunningMoments:
    """Welford-style streaming mean/variance over per-example scalars.

    Same recurrence as the reference RunningStats (datasets/utils.py:71-103):
    the mean tracks per-example means; the second moment accumulates
    (x − m_{k−1})(x − m_k) elementwise, whose mean/(n−1) is the variance
    estimate the reference extracts.
    """

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._s: Optional[np.ndarray] = None

    def push(self, x: np.ndarray) -> None:
        self.n += 1
        xm = float(x.mean())
        if self.n == 1:
            self._mean = xm
            self._s = np.zeros_like(x, dtype=np.float64)
        else:
            old_mean = self._mean
            self._mean = old_mean + (xm - old_mean) / self.n
            self._s = self._s + (x - old_mean) * (x - self._mean)

    def mean(self) -> float:
        return self._mean if self.n else 0.0

    def variance_mean(self) -> float:
        """Mean of the elementwise variance map (what the reference reduces)."""
        if self.n <= 1:
            return 0.0
        return float((self._s / (self.n - 1)).mean())


def compute_norm_params(dataset) -> dict:
    """One streaming pass: global min/max/mean/std for inputs and outputs.

    Same output dict keys as the reference normalize_dataset
    (datasets/utils.py:58-61).
    """
    in_stats, out_stats = RunningMoments(), RunningMoments()
    mx_in = mn_in = mx_out = mn_out = None
    for i in range(len(dataset)):
        x, y = dataset[i]
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        mx_in = x.max() if mx_in is None else max(mx_in, x.max())
        mn_in = x.min() if mn_in is None else min(mn_in, x.min())
        mx_out = y.max() if mx_out is None else max(mx_out, y.max())
        mn_out = y.min() if mn_out is None else min(mn_out, y.min())
        in_stats.push(x)
        out_stats.push(y)
    return {
        "input_max": float(mx_in),
        "input_min": float(mn_in),
        "input_mean": in_stats.mean(),
        "input_std": float(np.sqrt(in_stats.variance_mean())),
        "output_max": float(mx_out),
        "output_min": float(mn_out),
        "output_mean": out_stats.mean(),
        "output_std": float(np.sqrt(out_stats.variance_mean())),
    }


def normalize_dataset(dataset):
    """Attach ``norm_params`` to the dataset, using the pickle cache if present.

    Contract matches the reference normalize_dataset (datasets/utils.py:35-69):
    cache file ``<dataset.cache_path>/norm_params.pickle``; the statistics
    pass runs over the *raw* (un-normalized) examples, so the dataset must
    expose them un-normalized until ``norm_params`` is set.
    """
    cache_file = None
    if getattr(dataset, "cache_path", None):
        cache_file = os.path.join(dataset.cache_path, "norm_params.pickle")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fh:
                dataset.norm_params = pickle.load(fh)
            print("normalized with parameters from cache")
            return dataset
    params = compute_norm_params(dataset)
    dataset.norm_params = params
    if cache_file is not None:
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        with open(cache_file, "wb") as fh:
            pickle.dump(params, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return dataset
