"""Metrics/observability backbone: disk-first, wandb-optional.

The reference routes all observability through a live wandb session —
scalars, gradients, and image panels (reference: core/scripts/train.py:126,
167; core/scripts/router.py:147-165). That makes runs impossible without
network. Here metrics always land on disk (JSONL lines + PNG image dumps)
and wandb is an optional mirror, enabled only when importable and not
disabled via WANDB_MODE.

The port's copy of ``im2im_uq_tpu/utils/logging.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

__all__ = ["MetricsLogger", "to_uint8_image"]


def to_uint8_image(x: np.ndarray, self_normalize: bool = True) -> np.ndarray:
    """Squash an array to a uint8 image, reference-style.

    Mirrors transform_output (reference: core/scripts/eval.py:14-22):
    optional min/max self-normalization, scale by 255, clip to [0, 255].
    Accepts (H, W), (H, W, 1), (H, W, C), or singleton-batch variants.
    """
    x = np.asarray(x, dtype=np.float32)
    x = np.squeeze(x)
    if self_normalize:
        x = x - x.min()
        mx = x.max()
        if mx > 0:
            x = x / mx
    x = np.maximum(0.0, np.minimum(255.0 * x, 255.0))
    return x.astype(np.uint8)


class MetricsLogger:
    """Append-only JSONL metric log + PNG image dumps, with optional wandb.

    ``log(dict)`` mirrors wandb.log; ``log_images(tag, [arrays])`` writes
    PNGs under ``<dir>/images/``. Constructing with ``output_dir=None``
    degrades to a no-op disk logger (still mirrors to wandb if live).
    """

    def __init__(self, output_dir: Optional[str], use_wandb: bool = True, config: dict | None = None):
        self.output_dir = Path(output_dir) if output_dir else None
        self._fh = None
        if self.output_dir is not None:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.output_dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb and os.environ.get("WANDB_MODE", "") not in ("disabled", "offline-disabled"):
            try:
                import wandb  # type: ignore

                if wandb.run is not None:
                    self._wandb = wandb
            except Exception:
                self._wandb = None
        self.config = config or {}

    def log(self, metrics: dict[str, Any]) -> None:
        record = {"_time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, (np.ndarray, np.generic)):
                v = v.tolist()
            elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
                v = v.item()
            elif hasattr(v, "tolist"):
                v = np.asarray(v).tolist()
            record[k] = v
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            try:
                self._wandb.log(metrics)
            except Exception:
                pass

    def log_images(self, tag: str, images: list[np.ndarray], step: Any = None) -> list[str]:
        """Write uint8 arrays as PNGs; returns the file paths."""
        paths: list[str] = []
        if self.output_dir is None:
            return paths
        img_dir = self.output_dir / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        try:
            from PIL import Image
        except ImportError:
            return paths
        for i, arr in enumerate(images):
            suffix = f"_{step}" if step is not None else ""
            path = img_dir / f"{tag}{suffix}_{i}.png"
            Image.fromarray(np.asarray(arr)).save(path)
            paths.append(str(path))
        return paths

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
