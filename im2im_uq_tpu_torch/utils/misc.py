"""Misc utilities: pickle memoization, loss plotting, scale conversion.

Counterpart of the reference's core utils grab-bag (reference:
core/utils.py:21-85 — ``cacheable``, ``standard_to_minmax``, ``plot_loss``;
``fix_randomness`` lives in utils/random.py and the eager normalize helpers
in data/normalize.py).

The port's copy of ``im2im_uq_tpu/utils/misc.py`` (the port imports
nothing of the JAX package); matplotlib is imported only by
:func:`plot_loss`.
"""

from __future__ import annotations

import os
import pathlib
import pickle

import numpy as np

__all__ = ["cacheable", "standard_to_minmax", "plot_loss"]


def cacheable(func):
    """Disk-memoize a function by (name, args) pickle (core/utils.py:21-35)."""

    def cache_func(*args):
        cache_dir = str(pathlib.Path(__file__).parent.absolute()) + "/.cache/"
        os.makedirs(cache_dir, exist_ok=True)
        fname = cache_dir + func.__name__ + str(args) + ".pkl"
        if os.path.exists(fname):
            with open(fname, "rb") as fh:
                return pickle.load(fh)
        result = func(*args)
        with open(fname, "wb") as fh:
            pickle.dump(result, fh)
        return result

    return cache_func


def standard_to_minmax(x, config: dict, output_bool: bool):
    """Convert standard-normalized values to min-max scale.

    The reference version (core/utils.py:72-78) reads ``output_mean`` for
    all four statistics — a bug that is harmless there because the function
    is imported but never called. This implements the intended conversion:
    un-standardize with (mean, std), then min-max with (min, max).
    """
    tag = "output" if output_bool else "input"
    mu = config[f"{tag}_mean"]
    std = config[f"{tag}_std"]
    lb = config[f"{tag}_min"]
    ub = config[f"{tag}_max"]
    return ((x * std) + mu - lb) / (ub - lb)


def plot_loss(losses, step: int, path: str) -> None:
    """Save a loss-curve PNG/PDF (core/utils.py:80-85)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(np.arange(1, len(losses) + 1) * step, losses)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close()
