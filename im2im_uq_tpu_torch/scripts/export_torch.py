"""CLI: write one of the port's checkpoints as a reference-layout state dict.

Counterpart of ``im2im_uq_tpu/scripts/export_torch.py``:

    python -m im2im_uq_tpu_torch.scripts.export_torch \\
        --checkpoint ckpts/CP_calibrated_*.pt \\
        --config experiments/fastmri_test/config.yml \\
        --output model_reference.pth [--device cuda]

The checkpoint (a training ``CP_epoch*.pt`` or a ``CP_calibrated_*.pt``) is
loaded through ``scripts/infer.load_uq_state_for_inference`` on ``--device``
(default ``cuda``; ``cpu`` on request). The output is what the JAX
package's ``interop/torch_export.export_state_dict`` writes for the same
weights, bit for bit: the reference ``ModelWithUncertainty``'s keys
(``baseModel.*`` / ``last_layer.*``), float32 CPU tensors, every
``num_batches_tracked`` 0 (the JAX package keeps no counter; eval does not
read it) and, when the model is calibrated, ``lhat`` as a float32 scalar.
It loads into the reference module with ``load_state_dict`` (call
``set_lhat`` first, or load with ``strict=False``, when λ̂ is included:
the reference registers that buffer as None until calibration). The
inverse of ``scripts.import_torch``.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from im2im_uq_tpu_torch.models.assembly import UQModel

__all__ = ["export_state_dict", "main"]


def export_state_dict(model: UQModel, lhat: Optional[float] = None) -> dict:
    """The model's state dict in the JAX package's export layout."""
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(0, dtype=torch.int64)
        else:
            out[name] = t.detach().to("cpu", copy=True).contiguous()
    if lhat is not None:
        out["lhat"] = torch.tensor(float(lhat), dtype=torch.float32)
    return out


def main(argv: Optional[list[str]] = None) -> int:
    from im2im_uq_tpu_torch.scripts.infer import load_uq_state_for_inference
    from im2im_uq_tpu_torch.scripts.router import resolve_device
    from im2im_uq_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True, help="the port's checkpoint (.pt)")
    parser.add_argument("--config", required=True, help="config YAML (wandb sweep schema ok)")
    parser.add_argument("--grid-index", type=int, default=0)
    parser.add_argument("--output", required=True, help="output .pth path")
    parser.add_argument("--device", default="cuda", help="torch device to load the model on")
    args = parser.parse_args(argv)

    config = load_config(args.config)[args.grid_index]
    state = load_uq_state_for_inference(config, args.checkpoint, resolve_device(args.device))
    torch.save(export_state_dict(state.model, state.lhat), args.output)
    lhat_note = f" (lhat={state.lhat})" if state.lhat is not None else ""
    print(f"Exported reference-layout state_dict: {args.output}{lhat_note}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
