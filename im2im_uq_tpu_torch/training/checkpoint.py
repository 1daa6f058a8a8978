"""Checkpoints with the JAX package's filename contract.

Counterpart of ``im2im_uq_tpu/training/checkpoint.py``:

- training checkpoints ``CP_epoch{e}_{key}.pt`` (the JAX stem with a ``.pt``
  suffix) hold ``{"state_dict", "optimizer", "lhat", "epoch"}``: the model's
  state dict in the export layout (the reference's ``baseModel.*`` /
  ``last_layer.*`` keys) on the CPU, the optimizer's ``state_dict()``, λ̂
  (NaN for none) and the epoch; :func:`find_resume_checkpoint` probes them
  in the JAX order;
- the serving artifact ``CP_calibrated_{key}.pt`` holds ``{"state_dict",
  "lhat", "epoch"}``.

Every file is written to a temporary name and renamed into place, so a
reader never sees half a checkpoint. Over a data-parallel mesh rank 0
alone writes (``train_net``, the router and the calibrate CLI call these
functions there only, then wait at a barrier), and every rank loads. The JAX package's orbax and msgpack
backends and its mid-epoch checkpoints are not ported.
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
    "checkpoint_path",
    "find_resume_checkpoint",
    "load_calibrated_checkpoint",
    "restore_checkpoint",
    "save_calibrated_checkpoint",
    "save_checkpoint",
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


def checkpoint_path(checkpoint_dir: str, epoch: int, config: dict) -> str:
    """Training checkpoint after ``epoch`` epochs."""
    return os.path.join(checkpoint_dir, f"CP_epoch{epoch}_{checkpoint_key(config)}.pt")


def calibrated_checkpoint_path(checkpoint_dir: str, config: dict) -> str:
    """Post-calibration artifact carrying λ̂: the serving entry point."""
    return os.path.join(checkpoint_dir, f"CP_calibrated_{checkpoint_key(config)}.pt")


def _cpu_state_dict(model: UQModel) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _write(payload: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(
    path: str,
    uq_model: UQModel,
    optimizer: torch.optim.Optimizer,
    lhat: Optional[float],
    epoch: int,
) -> None:
    """Write a training checkpoint: weights, optimizer state, λ̂ and epoch."""
    _write(
        {
            "state_dict": _cpu_state_dict(uq_model),
            "optimizer": optimizer.state_dict(),
            "lhat": math.nan if lhat is None else float(lhat),
            "epoch": int(epoch),
        },
        path,
    )


def restore_checkpoint(
    path: str, uq_model: UQModel, optimizer: torch.optim.Optimizer
) -> tuple[Optional[float], int]:
    """Load a training checkpoint into ``uq_model`` (strict) and
    ``optimizer`` in place → (λ̂ or None, epoch)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    uq_model.load_state_dict(payload["state_dict"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    lhat = float(payload["lhat"])
    return (None if math.isnan(lhat) else lhat), int(payload["epoch"])


def find_resume_checkpoint(
    checkpoint_dir: str, epochs: int, config: dict
) -> tuple[Optional[str], int]:
    """(path, starting_epoch): the final-epoch checkpoint first, else the
    newest earlier one scanning down from ``epochs − 1``, else (None, 0) —
    the probe order of ``im2im_uq_tpu/training/checkpoint.py:277-298``."""
    final = checkpoint_path(checkpoint_dir, epochs, config)
    if os.path.exists(final):
        return final, epochs
    for e in reversed(range(epochs)):
        p = checkpoint_path(checkpoint_dir, e, config)
        if os.path.exists(p):
            return p, e
    return None, 0


def save_calibrated_checkpoint(uq_state: UQState, config: dict, checkpoint_dir: str) -> str:
    """Write the λ̂-bearing serving artifact; returns its path."""
    path = calibrated_checkpoint_path(checkpoint_dir, config)
    _write(
        {
            "state_dict": _cpu_state_dict(uq_state.model),
            "lhat": math.nan if uq_state.lhat is None else float(uq_state.lhat),
            "epoch": int(config.get("epochs", 0)),
        },
        path,
    )
    return path


def load_calibrated_checkpoint(path: str, uq_model: UQModel) -> tuple[Optional[float], int]:
    """Load the weights into ``uq_model`` (strict) → (λ̂ or None, epoch)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    uq_model.load_state_dict(payload["state_dict"], strict=True)
    lhat = float(payload["lhat"])
    return (None if math.isnan(lhat) else lhat), int(payload["epoch"])
