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
functions there only, then wait at a barrier), and every rank loads.

``checkpoint_backend`` picks the JAX package's file format: "flax"
(msgpack, its default) or "orbax" (a directory); the JAX package writes
msgpack for any other value too. The port writes the same ``.pt`` file for
every value, so it reads the key nowhere. ``save_checkpoint(...,
async_save=True)`` (``async_checkpoint: true`` in ``train_net``, for any
backend; the JAX package overlaps only its orbax saves) copies the
checkpoint to host memory at once and writes it with ``torch.save`` on one
background thread, so the write overlaps the next epoch;
:func:`wait_for_async_saves` waits for the writes and raises the first
that failed. The resume scan and every read wait first, and ``train_net``
waits before it returns. The JAX package's mid-epoch checkpoints are not
ported.
"""

from __future__ import annotations

import concurrent.futures
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
    "wait_for_async_saves",
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


def _host_copy(tree):
    """``tree`` with every tensor copied to host memory, also those already
    there: training goes on updating the originals in place."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _write(payload: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class _BackgroundWriter:
    """One thread that writes checkpoints in the order they were saved."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(1, "checkpoint-writer")
        self._pending: list[concurrent.futures.Future] = []

    def submit(self, payload: dict, path: str) -> None:
        self._pending.append(self._pool.submit(_write, payload, path))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        concurrent.futures.wait(pending)  # every write ends before one raises
        for future in pending:
            future.result()


_WRITER = _BackgroundWriter()


def wait_for_async_saves() -> None:
    """Block until every background save has been written; raise the
    first that failed."""
    _WRITER.wait()


def save_checkpoint(
    path: str,
    uq_model: UQModel,
    optimizer: torch.optim.Optimizer,
    lhat: Optional[float],
    epoch: int,
    async_save: bool = False,
) -> None:
    """Write a training checkpoint: weights, optimizer state, λ̂ and epoch.

    ``async_save``: copy them to host memory now and write the file on the
    background thread (call :func:`wait_for_async_saves` before relying on
    it; the readers here do)."""
    payload = {
        "state_dict": _cpu_state_dict(uq_model),
        "optimizer": optimizer.state_dict(),
        "lhat": math.nan if lhat is None else float(lhat),
        "epoch": int(epoch),
    }
    if async_save:
        _WRITER.submit(_host_copy(payload), path)
    else:
        _write(payload, path)


def restore_checkpoint(
    path: str, uq_model: UQModel, optimizer: torch.optim.Optimizer
) -> tuple[Optional[float], int]:
    """Load a training checkpoint into ``uq_model`` (strict) and
    ``optimizer`` in place → (λ̂ or None, epoch)."""
    wait_for_async_saves()
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
    wait_for_async_saves()  # a pending save's file is not there yet
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
    wait_for_async_saves()
    payload = torch.load(path, map_location="cpu", weights_only=True)
    uq_model.load_state_dict(payload["state_dict"], strict=True)
    lhat = float(payload["lhat"])
    return (None if math.isnan(lhat) else lhat), int(payload["epoch"])
