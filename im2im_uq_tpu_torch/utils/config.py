"""Config system: wandb-sweep-YAML-compatible grid configs, no wandb needed.

The reference's single config surface is a wandb sweep YAML (``parameters:``
with ``value:``/``values:`` entries) executed by a wandb agent that spawns
one router process per grid point (reference: experiments/fastmri_test/
config.yml:2-73, README.md:26-34). This loader ingests the *same YAML
schema* — reference config files work unchanged — and expands the grid
locally, so experiments run with or without wandb.

The port's copy of ``im2im_uq_tpu/utils/config.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Any

import yaml

__all__ = ["load_sweep", "expand_grid", "load_config", "DEFAULTS"]

# Defaults for keys the pipeline reads but a minimal config may omit.
DEFAULTS: dict[str, Any] = {
    "model": "UNet",
    "rcps_loss": "fraction_missed",
    "alpha": 0.1,
    "delta": 0.1,
    "num_lambdas": 100,
    "minimum_lambda": 0.0,
    "maximum_lambda": 6.0,
    "minimum_lambda_softmax": 0.0,
    "maximum_lambda_softmax": 1.2,
    "load_from_checkpoint": False,
    "checkpoint_dir": None,
    "checkpoint_every": 1,
    "validate_every": 10,
    "num_validation_images": 10,
    "input_normalization": "standard",
    "output_normalization": "min-max",
    "q_lo": 0.05,
    "q_hi": 0.95,
    "q_lo_weight": 1,
    "q_hi_weight": 1,
    "mse_weight": 1,
    "num_softmax": 50,
    "beta": 0.1,
    "num_inputs": 1,
    "output_dir": None,
    "device": "tpu",
    "seed": 0,
}


def load_sweep(path: str | Path) -> dict:
    """Parse a sweep YAML (wandb schema or a plain flat mapping)."""
    with open(path) as fh:
        return yaml.safe_load(fh)


def expand_grid(sweep: dict) -> list[dict]:
    """Expand ``parameters:`` value/values entries into the full grid.

    Grid order iterates later ``values`` keys fastest, matching
    itertools.product over keys in declaration order.
    """
    params = sweep.get("parameters")
    if params is None:
        # plain flat config — a single grid point
        return [dict(DEFAULTS, **sweep)]
    fixed: dict[str, Any] = {}
    sweep_keys: list[str] = []
    sweep_vals: list[list] = []
    for key, spec in params.items():
        if isinstance(spec, dict) and "values" in spec:
            sweep_keys.append(key)
            sweep_vals.append(list(spec["values"]))
        elif isinstance(spec, dict) and "value" in spec:
            fixed[key] = spec["value"]
        else:
            fixed[key] = spec
    grid = []
    for combo in itertools.product(*sweep_vals) if sweep_keys else [()]:
        cfg = dict(DEFAULTS)
        cfg.update(fixed)
        cfg.update(dict(zip(sweep_keys, combo)))
        grid.append(cfg)
    return grid


def load_config(path: str | Path, grid_index: int | None = None) -> list[dict]:
    """Load a sweep file; return all grid points, or just one if indexed."""
    grid = expand_grid(load_sweep(path))
    if grid_index is not None:
        return [grid[grid_index]]
    return grid
