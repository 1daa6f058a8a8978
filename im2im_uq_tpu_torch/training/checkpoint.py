"""Checkpoints of calibrated models, with the JAX package's filename contract.

Counterpart of ``im2im_uq_tpu/training/checkpoint.py`` for the serving
artifact: ``CP_calibrated_{key}.pt`` holds ``{"state_dict", "lhat",
"epoch"}``, where the state dict is in the export layout (the reference's
``baseModel.*`` / ``last_layer.*`` keys) on the CPU. Training checkpoints
and optimizer state are not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from im2im_uq_tpu_torch.models.assembly import UQModel, UQState

__all__ = [
    "calibrated_checkpoint_path",
    "checkpoint_key",
    "load_calibrated_checkpoint",
    "save_calibrated_checkpoint",
]


def checkpoint_key(config: dict) -> str:
    """Config-keyed filename stem (same fields as reference train.py:81)."""
    return "_".join(
        [
            str(config["dataset"]),
            str(config["uncertainty_type"]),
            str(config["batch_size"]),
            str(config["lr"]),
            str(config["input_normalization"]),
            str(config["output_normalization"]).replace(".", "_"),
        ]
    )


def calibrated_checkpoint_path(checkpoint_dir: str, config: dict) -> str:
    """Post-calibration artifact carrying λ̂: the serving entry point."""
    return os.path.join(checkpoint_dir, f"CP_calibrated_{checkpoint_key(config)}.pt")


def save_calibrated_checkpoint(uq_state: UQState, config: dict, checkpoint_dir: str) -> str:
    """Write the λ̂-bearing serving artifact; returns its path."""
    state_dict = {k: v.detach().cpu() for k, v in uq_state.model.state_dict().items()}
    payload = {
        "state_dict": state_dict,
        "lhat": math.nan if uq_state.lhat is None else float(uq_state.lhat),
        "epoch": int(config.get("epochs", 0)),
    }
    path = calibrated_checkpoint_path(checkpoint_dir, config)
    os.makedirs(checkpoint_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_calibrated_checkpoint(path: str, uq_model: UQModel) -> tuple[Optional[float], int]:
    """Load the weights into ``uq_model`` (strict) → (λ̂ or None, epoch)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    uq_model.load_state_dict(payload["state_dict"], strict=True)
    lhat = float(payload["lhat"])
    return (None if math.isnan(lhat) else lhat), int(payload["epoch"])
