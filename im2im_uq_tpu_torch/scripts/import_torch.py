"""CLI: turn a reference-layout torch checkpoint into the port's checkpoints.

Counterpart of ``im2im_uq_tpu/scripts/import_torch.py``:

    python -m im2im_uq_tpu_torch.scripts.import_torch \\
        --checkpoint CP_epoch10_fastmri_quantiles_78_0.0001_standard_standard.pth \\
        --config experiments/fastmri_test/config.yml \\
        --output-dir ckpts/ [--epoch E] [--lhat L] [--device cuda] \\
        [--reference-path /path/to/im2im-uq]

The input is a bare state dict in the reference layout (what
``scripts.export_torch`` and the JAX package's ``export_torch`` write, λ̂
riding along as ``lhat``), or the reference's whole pickled
``nn.Module``, which needs the reference repo importable: point
``--reference-path`` at its root (its λ̂ is the module's ``lhat``). The
weights load strictly into the configured model on ``--device`` (default
``cuda``; ``cpu`` on request). Written into ``--output-dir``, with the
JAX package's filename contract: a resumable ``CP_epoch{e}_<key>.pt``
(a fresh Adam state), ``e`` from ``--epoch``, else from the input's
``CP_epoch{e}_`` name, else the config's ``epochs``; and, when λ̂ is
known, the serving artifact ``CP_calibrated_<key>.pt``.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Optional

import torch

__all__ = ["load_reference_state_dict", "main"]


def load_reference_state_dict(path: str,
                              reference_path: Optional[str] = None) -> tuple[dict, Optional[float]]:
    """(state dict without ``lhat``, λ̂ or None) of a reference checkpoint.

    A bare state dict loads without running pickled code; a whole module
    needs full unpickling (only load trusted files) with the reference repo
    on ``sys.path`` while it loads."""
    inserted = reference_path if reference_path and reference_path not in sys.path else None
    if inserted:
        sys.path.insert(0, inserted)
    try:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:
            obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if inserted:
            sys.path.remove(inserted)
    lhat = None
    if hasattr(obj, "state_dict"):
        raw = getattr(obj, "lhat", None)
        obj = obj.state_dict()
    else:
        obj = dict(obj)
        raw = obj.get("lhat")
    obj.pop("lhat", None)
    if raw is not None:
        lhat = float(raw.item() if hasattr(raw, "item") else raw)
    return obj, lhat


def main(argv: Optional[list[str]] = None) -> int:
    from im2im_uq_tpu_torch.models.assembly import add_uncertainty, build_trunk
    from im2im_uq_tpu_torch.scripts.router import resolve_device
    from im2im_uq_tpu_torch.training.checkpoint import (
        checkpoint_path,
        save_calibrated_checkpoint,
        save_checkpoint,
    )
    from im2im_uq_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True, help="reference .pth file")
    parser.add_argument("--config", required=True, help="config YAML (wandb sweep schema ok)")
    parser.add_argument("--grid-index", type=int, default=0)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--reference-path", default=None,
                        help="reference repo root (needed to unpickle its modules)")
    parser.add_argument("--epoch", type=int, default=None,
                        help="epoch tag for the output filename "
                             "(default: parsed from CP_epoch{e}_* input name)")
    parser.add_argument("--lhat", type=float, default=None,
                        help="override/provide the calibrated lambda-hat")
    parser.add_argument("--device", default="cuda", help="torch device to build the model on")
    args = parser.parse_args(argv)

    config = load_config(args.config)[args.grid_index]
    sd, lhat = load_reference_state_dict(args.checkpoint, args.reference_path)
    if args.lhat is not None:
        lhat = args.lhat
    state = add_uncertainty(build_trunk(config), config, device=resolve_device(args.device))
    state.model.load_state_dict(sd, strict=True)
    state = state.replace(lhat=lhat)

    epoch = args.epoch
    if epoch is None:
        m = re.search(r"CP_epoch(\d+)_", args.checkpoint)
        epoch = int(m.group(1)) if m else int(config.get("epochs", 0))
    optimizer = torch.optim.Adam(state.model.parameters(), lr=float(config.get("lr", 1e-3)))
    path = checkpoint_path(args.output_dir, epoch, config)
    save_checkpoint(path, state.model, optimizer, lhat, epoch)
    print(f"Imported: {path}")
    if lhat is not None:
        cal = save_calibrated_checkpoint(state, config, args.output_dir)
        print(f"Calibrated serving artifact: {cal}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
