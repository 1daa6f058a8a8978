"""Calibrate-only CLI: re-run RCPS on an existing checkpoint, no retraining.

Counterpart of ``im2im_uq_tpu/scripts/calibrate.py``, for the workflow
"train once, re-calibrate per deployment, serve": load any port checkpoint
(a training ``CP_epoch*.pt`` or a ``CP_calibrated_*.pt``), run the RCPS
grid search (``calibration/rcps.calibrate_model``: descend the λ grid,
loss at λ − dλ, HB/WSR bound, stop rule) on a dataset, and write into
``--output-dir``

- the λ̂-bearing ``CP_calibrated_<key>.pt``, which ``scripts.infer`` and
  ``scripts.export_serving`` read,
- ``calibration_loss_table.npz``, the (N, num_lambdas) table under the key
  ``loss_table``, for risk audits,
- ``calibration_summary.json``, also printed as one JSON line.

Usage:
    python -m im2im_uq_tpu_torch.scripts.calibrate \\
        --config experiments/synthetic_test/config.yml \\
        --checkpoint checkpoints/CP_epoch4_....pt \\
        --output-dir out/ [--data-path ...] [--alpha 0.1] [--delta 0.1] \\
        [--calib-fraction 1.0] [--seed 0] [--device cuda]

The whole dataset is calibrated on unless ``--calib-fraction`` asks for a
random subset, drawn as the JAX CLI draws it. The model runs on
``--device`` (default ``cuda``; ``cpu`` on request), where the loss table
takes K2 unless the config names a ``loss_table_method``.

As the JAX CLI calibrates over its mesh of every visible device, this one
calibrates over every visible GPU (``CUDA_VISIBLE_DEVICES`` limits them),
one process each: it starts one worker per GPU itself, or each process
joins the group under a launcher (``python -m torch.distributed.run
--nproc_per_node N -m im2im_uq_tpu_torch.scripts.calibrate ...``). Every
rank computes the same table and λ̂; rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from im2im_uq_tpu_torch.calibration.rcps import calibrate_model
from im2im_uq_tpu_torch.data.core import random_split, split_lengths
from im2im_uq_tpu_torch.parallel import distributed
from im2im_uq_tpu_torch.scripts.infer import load_uq_state_for_inference
from im2im_uq_tpu_torch.scripts.router import build_dataset, resolve_device
from im2im_uq_tpu_torch.training.checkpoint import save_calibrated_checkpoint
from im2im_uq_tpu_torch.utils.config import DEFAULTS, load_config
from im2im_uq_tpu_torch.utils.random import fix_randomness

__all__ = ["main"]


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True, help="experiment config YAML")
    ap.add_argument("--checkpoint", required=True, help="checkpoint to calibrate (.pt)")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--data-path", default=None, help="override config data_path")
    ap.add_argument("--alpha", type=float, default=None, help="override risk level α")
    ap.add_argument("--delta", type=float, default=None, help="override confidence δ")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument(
        "--calib-fraction", type=float, default=1.0,
        help="random fraction of the dataset to calibrate on (default: all)",
    )
    ap.add_argument("--grid-index", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device to calibrate on")
    args = ap.parse_args(argv)

    config = dict(DEFAULTS)
    config.update(load_config(args.config, grid_index=args.grid_index)[0])
    if args.data_path:
        config["data_path"] = args.data_path
    if args.alpha is not None:
        config["alpha"] = args.alpha
    if args.delta is not None:
        config["delta"] = args.delta
    fix_randomness(args.seed)
    device = resolve_device(args.device)
    rc, mesh = distributed.join_or_spawn("im2im_uq_tpu_torch.scripts.calibrate", argv, device)
    if rc is not None:
        return rc  # the workers, one per GPU, calibrated and wrote
    if mesh is not None:
        device = mesh.device

    state = load_uq_state_for_inference(config, os.path.expanduser(args.checkpoint), device)
    dataset = build_dataset(config)
    if args.calib_fraction < 1.0 and hasattr(dataset, "__len__"):
        keep, _ = split_lengths(len(dataset), [args.calib_fraction, 1 - args.calib_fraction])
        dataset = random_split(
            dataset, [keep, len(dataset) - keep], np.random.RandomState(args.seed)
        )[0]

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, loss_table = calibrate_model(
        state, dataset, config, mesh=mesh,
        batch_size=args.batch_size or config.get("batch_size", 32),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calib_seconds = time.perf_counter() - t0
    if mesh is not None and not mesh.is_main:
        return 0

    out_dir = Path(os.path.expanduser(args.output_dir))
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_path = save_calibrated_checkpoint(state, config, str(out_dir))

    table_path = out_dir / "calibration_loss_table.npz"
    np.savez(table_path, loss_table=np.asarray(loss_table))

    summary = {
        "lhat": state.lhat,
        "alpha": config["alpha"],
        "delta": config["delta"],
        "num_calibration_examples": int(loss_table.shape[0]),
        "num_lambdas": int(loss_table.shape[1]),
        "calibration_seconds": round(calib_seconds, 3),
        "checkpoint": ckpt_path,
        "loss_table": str(table_path),
    }
    with open(out_dir / "calibration_summary.json", "w") as fh:
        json.dump(summary, fh)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
