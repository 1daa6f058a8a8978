"""Batch inference / serving CLI: calibrated checkpoint → per-pixel intervals.

Counterpart of ``im2im_uq_tpu/scripts/infer.py``: load a calibrated
checkpoint (weights + λ̂), stream inputs through the model at a fixed batch
shape (the tail is zero-padded; eval-mode BatchNorm uses running stats, so
padding never touches real outputs), and write one ``{name}_intervals.npz``
(lower / prediction / upper, plus lam) per input file and an
``inference_summary.json``.

Usage:
    python -m im2im_uq_tpu_torch.scripts.infer \
        --config experiments/synthetic_test/config.yml \
        --checkpoint checkpoints/CP_calibrated_....pt \
        --input inputs.npy --output out/ [--lam 2.5] [--batch-size 32] \
        [--device cuda]

or, from a serving artifact of ``scripts.export_serving`` (λ̂ and the
batch shape baked in, no config or checkpoint):
    python -m im2im_uq_tpu_torch.scripts.infer --artifact model.uq.pt2 \
        --input inputs.npy --output out/ [--device cuda]

Inputs: a ``.npy``/``.npz`` array of shape (N, H, W, C) or (H, W, C), or a
directory of such files (sorted order), normalized as in training.

``--data-parallel`` with more than one visible GPU (``CUDA_VISIBLE_DEVICES``
limits them) serves over all of them, one process each, as the JAX CLI
serves over its mesh: without a launcher the CLI starts one worker per GPU
itself, under one (``python -m torch.distributed.run --nproc_per_node N -m
im2im_uq_tpu_torch.scripts.infer --data-parallel ...``) each process joins
the group. Each rank runs its slice of every batch (the batch size rounded
up to a multiple of the ranks), every rank gathers the intervals, and rank
0 writes the files. ``--spatial`` runs over the same ranks, but splits each
image's rows over them instead of the batch (``parallel/spatial.py``;
images one at a time, :func:`predict_intervals_spatial`), for tiles too
large for one GPU.

A data-parallel artifact (``export_serving --n-devices N``) needs no flag:
the CLI starts its N ranks itself, one per GPU (or joins them under a
launcher), each runs its slice of every batch, and rank 0 writes. On fewer
than N GPUs it is refused. ``--data-parallel`` and ``--spatial`` do not
apply to an artifact, whose sharding is fixed at export.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from im2im_uq_tpu_torch.models.assembly import (
    UQState,
    add_uncertainty,
    build_trunk,
    nchw_from_nhwc,
)
from im2im_uq_tpu_torch.parallel import distributed
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.scripts.export_serving import (
    artifact_meta,
    fewer_devices_error,
    load_serving_artifact,
)
from im2im_uq_tpu_torch.training.checkpoint import load_calibrated_checkpoint
from im2im_uq_tpu_torch.utils.config import DEFAULTS, load_config

__all__ = [
    "load_uq_state_for_inference", "main", "predict_intervals", "predict_intervals_spatial",
]


def load_uq_state_for_inference(
    config: dict, checkpoint: str, device: torch.device | str
) -> UQState:
    """Rebuild the model from config on ``device`` and load weights and λ̂."""
    state = add_uncertainty(build_trunk(config), config, device=device)
    lhat, _epoch = load_calibrated_checkpoint(checkpoint, state.model)
    return state.replace(lhat=lhat)


def _iter_input_arrays(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (name, (N,H,W,C) float32 array) from a file or directory."""
    p = Path(os.path.expanduser(path))
    files = (
        sorted(q for q in p.iterdir() if q.suffix in (".npy", ".npz"))
        if p.is_dir()
        else [p]
    )
    if not files:
        raise FileNotFoundError(f"no .npy/.npz inputs under {path}")
    seen: set[str] = set()
    for f in files:
        if f.suffix == ".npz":
            with np.load(f) as z:
                arr = z[z.files[0]]
        else:
            arr = np.load(f)
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4:
            raise ValueError(f"{f}: expected (N,H,W,C) or (H,W,C), got {arr.shape}")
        if arr.shape[0] == 0:
            raise ValueError(f"{f}: contains no images (shape {arr.shape})")
        # 'a.npy' and 'a.npz' in one directory must not collide on 'a'
        name = f.stem if f.stem not in seen else f.stem + f.suffix.replace(".", "_")
        seen.add(name)
        yield name, arr


def predict_intervals(
    state: UQState,
    inputs: np.ndarray,
    batch_size: int = 32,
    lam: Optional[float] = None,
    mesh: Optional[mesh_lib.Mesh] = None,
) -> dict[str, np.ndarray]:
    """Calibrated nested sets over (N,H,W,C) inputs at a fixed batch shape.

    Returns {"lower", "prediction", "upper"}, each (N,H,W,C) float32. Over
    a ``mesh`` the batch size is rounded up to a multiple of the ranks,
    each rank runs its slice of every batch and every rank gets the whole
    result.
    """
    mesh_lib.check_mesh(mesh)
    batch_size = mesh_lib.mesh_batch_size(batch_size, mesh)
    n = inputs.shape[0]
    if n == 0:
        empty = np.zeros(inputs.shape, np.float32)
        return {"lower": empty, "prediction": empty.copy(), "upper": empty.copy()}
    device = state.device
    outs: dict[str, list[np.ndarray]] = {"lower": [], "prediction": [], "upper": []}
    for start in range(0, n, batch_size):
        chunk = inputs[start : start + batch_size]
        real = chunk.shape[0]
        if real < batch_size:
            pad = np.zeros((batch_size - real, *chunk.shape[1:]), chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        sets = state.nested_sets(nchw_from_nhwc(chunk, device), lam=lam, mesh=mesh)
        for key, t in zip(("lower", "prediction", "upper"), sets):
            outs[key].append(t[:real].permute(0, 2, 3, 1).cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def predict_intervals_spatial(
    state: UQState,
    inputs: np.ndarray,
    mesh: Optional[mesh_lib.Mesh],
    lam: Optional[float] = None,
) -> dict[str, np.ndarray]:
    """Calibrated nested sets with each image's height split over the
    ranks of ``mesh`` (``parallel/spatial.spatial_nested_sets``): the
    giant-tile serving path. Images run one at a time (the batch has
    nothing to split when one tile fills the mesh); every rank calls it and
    gets the whole result, {"lower", "prediction", "upper"}, each (N, H, W,
    C) float32."""
    from im2im_uq_tpu_torch.parallel.spatial import spatial_nested_sets

    fn = spatial_nested_sets(state, mesh, lam=lam)
    outs: dict[str, list[np.ndarray]] = {"lower": [], "prediction": [], "upper": []}
    for i in range(inputs.shape[0]):
        sets = fn(nchw_from_nhwc(inputs[i:i + 1], state.device))
        for key, t in zip(outs, sets):
            outs[key].append(t.permute(0, 2, 3, 1).cpu().numpy())
    empty = np.zeros(inputs.shape, np.float32)
    return {k: np.concatenate(v, axis=0) if v else empty.copy() for k, v in outs.items()}


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", help="experiment config YAML")
    ap.add_argument("--checkpoint", help="calibrated checkpoint (.pt)")
    ap.add_argument(
        "--artifact",
        help="serving artifact (scripts.export_serving) — replaces "
        "--config/--checkpoint; λ̂ and batch shape are baked in",
    )
    ap.add_argument("--input", required=True, help=".npy/.npz file or directory")
    ap.add_argument("--output", required=True, help="output directory for .npz results")
    # None means "not passed", whatever spelling of the flag was used
    ap.add_argument("--batch-size", type=int, default=None,
                    help="serving batch shape (default 32)")
    ap.add_argument(
        "--lam", type=float, default=None,
        help="interval scale λ override (default: the checkpoint's calibrated λ̂)",
    )
    ap.add_argument(
        "--grid-index", type=int, default=0,
        help="which grid point of a sweep config describes the checkpointed model",
    )
    ap.add_argument("--device", default="cuda", help="torch device to serve on")
    ap.add_argument(
        "--data-parallel", action="store_true",
        help="shard batches over all visible GPUs, one process each; "
        "single-device runs are unaffected",
    )
    ap.add_argument(
        "--spatial", action="store_true",
        help="shard each image's height over all visible GPUs, one process each "
        "(giant tiles that exceed one GPU's memory; images run one at a time); "
        "single-device runs are unaffected",
    )
    args = ap.parse_args(argv)

    if bool(args.artifact) == bool(args.config or args.checkpoint):
        raise SystemExit("pass either --artifact OR --config + --checkpoint")
    if args.data_parallel and args.spatial:
        raise SystemExit("--data-parallel and --spatial are mutually exclusive")
    # as the JAX CLI builds its mesh only over more than one device, the two
    # flags change nothing where one device of --device's type is visible
    devices = (int(os.environ["WORLD_SIZE"]) if distributed.launched()
               else distributed.visible_devices(args.device))
    sharded = (args.data_parallel or args.spatial) and devices > 1
    if sharded and args.artifact:
        raise SystemExit(
            "--data-parallel/--spatial only apply to --config/--checkpoint "
            "serving: an artifact's sharding is baked in at export time. "
            "For a data-parallel artifact, re-export with "
            "`export_serving --n-devices N` (it auto-shards at load); "
            "otherwise serve per-device processes."
        )
    # a data-parallel artifact runs over its own ranks, one a GPU
    n_art = int(artifact_meta(args.artifact).get("n_devices", 1)) if args.artifact else 1
    if n_art > 1 and not distributed.launched() and devices < n_art:
        raise SystemExit(str(fewer_devices_error(n_art, devices)))
    mesh = None
    if sharded or n_art > 1:
        rc, mesh = distributed.join_or_spawn("im2im_uq_tpu_torch.scripts.infer", argv,
                                             args.device, n_art if n_art > 1 else None)
        if rc is not None:
            return rc  # the workers, one per GPU, served and wrote
        args.device = str(mesh.device)
    elif distributed.launched():
        raise SystemExit("launched as one of several ranks: pass --data-parallel")

    if args.artifact:
        state = load_serving_artifact(args.artifact, torch.device(args.device))
        if state.idle:
            return 0  # a rank past the artifact's in a larger group
        if args.lam is not None and abs(args.lam - state.lhat) > 1e-9:
            raise SystemExit(
                f"--lam {args.lam} conflicts with the artifact's baked "
                f"λ̂={state.lhat} — re-export to change λ"
            )
        lam = state.lhat
        if args.batch_size is not None and args.batch_size != state.batch_size:
            print(
                f"warning: --batch-size {args.batch_size} ignored — the "
                f"artifact's program has a fixed batch shape of "
                f"{state.batch_size} (baked at export time)",
                file=sys.stderr,
            )
        args.batch_size = state.batch_size
        utype = state.uncertainty_type
    else:
        if not (args.config and args.checkpoint):
            raise SystemExit("--config and --checkpoint are both required")
        config = dict(DEFAULTS)
        config.update(load_config(args.config, grid_index=args.grid_index)[0])
        state = load_uq_state_for_inference(
            config, os.path.expanduser(args.checkpoint), torch.device(args.device)
        )
        lam = args.lam if args.lam is not None else state.lhat
        utype = config["uncertainty_type"]
    if lam is None:
        raise SystemExit("checkpoint has no calibrated λ̂ — pass --lam or calibrate first")
    if args.batch_size is None:
        args.batch_size = 32

    writes = mesh is None or mesh.is_main
    out_dir = Path(os.path.expanduser(args.output))
    out_dir.mkdir(parents=True, exist_ok=True)
    total, t0 = 0, time.perf_counter()
    for name, arr in _iter_input_arrays(args.input):
        if args.spatial and mesh is not None:
            result = predict_intervals_spatial(state, arr, mesh, lam=lam)
        else:
            # an artifact shards its batch itself
            result = predict_intervals(state, arr, args.batch_size, lam=lam,
                                       mesh=None if args.artifact else mesh)
        out = out_dir / f"{name}_intervals.npz"
        if writes:
            np.savez(out, lam=np.float64(lam), **result)
            print(f"{out}  ({arr.shape[0]} images)")
        total += arr.shape[0]
    dt = time.perf_counter() - t0
    if not writes:
        return 0
    summary = {
        "images": total,
        "seconds": round(dt, 3),
        "imgs_per_sec": round(total / dt, 2) if dt > 0 else math.inf,
        "lam": lam,
        "uncertainty_type": utype,
    }
    with open(out_dir / "inference_summary.json", "w") as fh:
        json.dump(summary, fh)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
