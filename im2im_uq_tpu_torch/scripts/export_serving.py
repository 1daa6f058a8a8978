"""Serving-artifact export: checkpoint + λ̂ → one self-contained file.

Counterpart of ``im2im_uq_tpu/scripts/export_serving.py``. The calibrated
nested-sets program (trunk → head → λ̂-scaled interval algebra) is traced
ahead of time with ``torch.export``; parameters, BatchNorm statistics and
λ̂ are baked into one ``torch.export.save`` archive, with the metadata as
JSON beside the program. The artifact

  * needs no model code to run, only torch (:func:`load_serving_artifact`),
  * is stored on the CPU, so that an artifact traced on the card loads on
    any host, and runs on each device type its ``platforms`` list,
  * bakes λ̂ into the program: serving cannot run uncalibrated intervals,
    and asking for another λ is an error.

The program is the JAX artifact's: the model rebuilt in its portable
configuration (``conv_backend``, ``pool_backend`` and ``resize_backend``
all ``"xla"``, metadata ``"program": "portable_xla"``), here cuDNN and
PyTorch ops with no kernel of the port in it, as the JAX artifact holds no
Pallas kernel. It is not a fallback: it computes exactly the function the
JAX artifact computes, and serving from ``--config``/``--checkpoint``
keeps the configured backends and their kernels. The exported function is
``x: (B, C, H, W) float32 → (lower, prediction, upper)``, each (B, C, H, W),
the port's ``UQState.nested_sets`` convention, so
``scripts.infer.predict_intervals`` drives an artifact unchanged. It runs
under the process's TF32 flags, as the live model does.

Usage:
    python -m im2im_uq_tpu_torch.scripts.export_serving \\
        --config experiments/synthetic_test/config.yml \\
        --checkpoint checkpoints/CP_calibrated_....pt \\
        --output model.uq.pt2 --height 320 --width 320 [--batch-size 32] \\
        [--lam 2.5] [--platforms cpu,cuda] [--device cuda]

Serve it with the infer CLI (no config or checkpoint needed):
    python -m im2im_uq_tpu_torch.scripts.infer --artifact model.uq.pt2 \\
        --input inputs.npy --output out/ [--device cuda]

A data-parallel artifact (``--n-devices`` > 1) is not yet ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Optional

import torch
from torch import nn

from im2im_uq_tpu_torch.models.assembly import UQState, add_uncertainty, build_trunk

__all__ = [
    "ARTIFACT_VERSION",
    "PLATFORMS",
    "ServingArtifact",
    "export_serving_artifact",
    "load_serving_artifact",
    "main",
    "portable_state",
]

ARTIFACT_VERSION = 1
# the device types an artifact can be exported for
PLATFORMS = ("cpu", "cuda")
_META = "meta.json"


def portable_state(state: UQState) -> UQState:
    """``state``'s model rebuilt under the ``"xla"`` conv, pool and resize
    backends on its device, with its weights and λ̂. Every backend has the
    same parameters, so only the traced program changes."""
    cfg = dict(state.params, conv_backend="xla", pool_backend="xla", resize_backend="xla")
    portable = add_uncertainty(build_trunk(cfg), cfg, device=state.device)
    portable.model.load_state_dict(state.model.state_dict(), strict=True)
    return portable.replace(lhat=state.lhat)


class _NestedSets(nn.Module):
    """x → ``state.nested_sets_from_output(model(x), lam)``, λ a constant."""

    def __init__(self, state: UQState, lam: float):
        super().__init__()
        self.model = state.model
        self._state = state
        self._lam = lam

    def forward(self, x: torch.Tensor):
        return self._state.nested_sets_from_output(self.model(x), self._lam)


def export_serving_artifact(
    state: UQState,
    path: str,
    *,
    batch_size: int = 32,
    height: int,
    width: int,
    channels: Optional[int] = None,
    lam: Optional[float] = None,
    platforms: tuple[str, ...] = PLATFORMS,
    n_devices: int = 1,
) -> dict:
    """Trace ``state``'s calibrated nested-sets program on its device and
    write it to ``path``, stored on the CPU; returns the metadata written
    beside it."""
    from torch.export.passes import move_to_device_pass

    if lam is None:
        lam = state.lhat
    if lam is None:
        raise ValueError(
            "model has no calibrated λ̂ — calibrate first or pass lam explicitly"
        )
    lam = float(lam)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices > 1:
        raise NotImplementedError(
            "a data-parallel artifact (n_devices > 1) is not yet ported to im2im_uq_tpu_torch"
        )
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be among {list(PLATFORMS)}, got {list(platforms)}")
    if channels is None:
        channels = int(state.params.get("num_inputs", 1))

    portable = portable_state(state)
    program = _NestedSets(portable, lam).eval()
    x = torch.zeros((batch_size, channels, height, width), dtype=torch.float32,
                    device=portable.device)
    with torch.no_grad():
        exported = torch.export.export(program, (x,))
    exported = move_to_device_pass(exported, "cpu")

    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "batch_size": batch_size,
        "height": height,
        "width": width,
        "channels": channels,
        "lam": lam,
        "uncertainty_type": state.uncertainty_type,
        "model": state.params.get("model", "UNet"),
        "compute_dtype": state.params.get("compute_dtype", "float32"),
        "platforms": list(platforms),
        "n_devices": n_devices,
        "param_count": int(sum(p.numel() for p in portable.model.parameters())),
        "torch_version": torch.__version__,
        # the program of the "xla" backends, as the JAX artifact's
        "program": "portable_xla",
    }
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.export.save(exported, path, extra_files={_META: json.dumps(meta)})
    return meta


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    """A loaded serving artifact with the part of the ``UQState`` surface
    that serving uses (``nested_sets``, ``lhat``, ``device``), so that
    ``infer.predict_intervals`` drives it unchanged. λ̂ is baked into the
    program: ``nested_sets(x, lam=...)`` with another λ is an error."""

    meta: dict
    device: torch.device
    _call: Callable

    @property
    def lhat(self) -> float:
        return float(self.meta["lam"])

    @property
    def batch_size(self) -> int:
        return int(self.meta["batch_size"])

    @property
    def uncertainty_type(self) -> str:
        return self.meta["uncertainty_type"]

    def nested_sets(self, x, lam=None, mesh=None):
        """(lower, pred, upper) of an NCHW batch of the artifact's shape.
        ``mesh`` is there for ``UQState``'s signature: an artifact's
        sharding is fixed at export."""
        if mesh is not None:
            raise ValueError(
                "serving artifacts bake their sharding at export time — "
                "re-export with --n-devices for a data-parallel artifact "
                "instead of passing mesh="
            )
        if lam is not None and abs(float(lam) - self.lhat) > 1e-9:
            raise ValueError(
                f"λ={lam} requested but λ̂={self.lhat} is baked into the "
                "artifact — re-export to change it"
            )
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self._call(x)


def load_serving_artifact(path: str, device: torch.device | str = "cuda") -> ServingArtifact:
    """Load an artifact written by :func:`export_serving_artifact` onto
    ``device``. Needs only torch: no model code, checkpoint or config."""
    from torch.export.passes import move_to_device_pass

    extra = {_META: ""}
    exported = torch.export.load(os.path.expanduser(path), extra_files=extra)
    meta = json.loads(extra[_META])
    if meta.get("artifact_version") != ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {meta.get('artifact_version')} != "
            f"supported {ARTIFACT_VERSION}"
        )
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(
            f"artifact was exported for platforms {meta['platforms']} but this "
            f"host runs {device.type!r} — re-export with --platforms {device.type}"
        )
    module = move_to_device_pass(exported, device).module()
    return ServingArtifact(meta=meta, device=device, _call=module)


def main(argv: Optional[list[str]] = None) -> int:
    from im2im_uq_tpu_torch.scripts.infer import load_uq_state_for_inference
    from im2im_uq_tpu_torch.scripts.router import resolve_device
    from im2im_uq_tpu_torch.utils.config import DEFAULTS, load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True, help="experiment config YAML")
    ap.add_argument("--checkpoint", required=True, help="training or calibrated checkpoint")
    ap.add_argument("--output", required=True, help="artifact path (.pt2)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument(
        "--lam", type=float, default=None,
        help="λ to bake in (default: the checkpoint's calibrated λ̂)",
    )
    ap.add_argument(
        "--platforms", default=",".join(PLATFORMS),
        help="comma-separated device types the artifact may run on (default cpu,cuda)",
    )
    ap.add_argument(
        "--n-devices", type=int, default=1,
        help="export the program data-parallel over this many devices (not yet ported)",
    )
    ap.add_argument("--grid-index", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device to load and trace on")
    args = ap.parse_args(argv)

    config = dict(DEFAULTS)
    config.update(load_config(args.config, grid_index=args.grid_index)[0])
    state = load_uq_state_for_inference(
        config, os.path.expanduser(args.checkpoint), resolve_device(args.device)
    )
    lam = args.lam if args.lam is not None else state.lhat
    if lam is None:
        raise SystemExit(
            "checkpoint has no calibrated λ̂ — pass --lam or calibrate first"
        )
    meta = export_serving_artifact(
        state,
        args.output,
        batch_size=args.batch_size,
        height=args.height,
        width=args.width,
        channels=int(config.get("num_inputs", 1)),
        lam=lam,
        platforms=tuple(p.strip() for p in args.platforms.split(",") if p.strip()),
        n_devices=args.n_devices,
    )
    size_mb = os.path.getsize(os.path.expanduser(args.output)) / 1e6
    print(json.dumps({**meta, "artifact_mb": round(size_mb, 2)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
