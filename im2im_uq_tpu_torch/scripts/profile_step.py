"""Where a train step's device time goes, per ``conv_backend`` and compute dtype.

    python -m im2im_uq_tpu_torch.scripts.profile_step

For each backend of ``unet.CONV_BACKENDS``, in float32 and then in bfloat16
(``compute_dtype``): the full-width UNet + quantile head (random weights
from a seed) at batch 32, 320x320, TF32 off, two warm-up steps of
``make_train_step`` on one batch already on the card, then three steps
under ``torch.profiler``. Prints one JSON line per backend and dtype: the
wall time per step (host clock around the synchronized
steps), the device-busy time (the union of the kernels' intervals), the
idle share, and the kernel time per step in the buckets of
``utils/profiling.py`` (the port's kernels by name; cuDNN's convolutions;
BatchNorm; Adam; copies; the rest) with the ten largest kernels. Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from im2im_uq_tpu_torch.models.assembly import add_uncertainty, build_trunk
from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
from im2im_uq_tpu_torch.models.unet import CONV_BACKENDS
from im2im_uq_tpu_torch.training import train
from im2im_uq_tpu_torch.utils import profiling
from im2im_uq_tpu_torch.utils.profiling import bucket

__all__ = ["CASES", "bucket", "main", "profile_backend"]

BATCH, IMAGE, STEPS = 32, 320, 3
# (conv_backend, compute_dtype) in the order they are profiled
CASES = [(backend, dtype) for dtype in ("float32", "bfloat16") for backend in CONV_BACKENDS]


def profile_backend(conv_backend: str, compute_dtype: str = "float32") -> dict:
    cfg = {"model": "UNet", "uncertainty_type": "quantiles", "q_lo": 0.05, "q_hi": 0.95,
           "q_lo_weight": 1.0, "q_hi_weight": 1.0, "mse_weight": 1.0, "lr": 1e-3,
           "conv_backend": conv_backend, "compute_dtype": compute_dtype}
    state = add_uncertainty(build_trunk(cfg), cfg,
                            generator=torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, IMAGE, IMAGE, 1).astype(np.float32)
    y = rng.rand(BATCH, IMAGE, IMAGE, 1).astype(np.float32)
    tensors = train.put_batch(x, y, np.ones((BATCH,), np.float32), torch.device("cuda"))
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(state.model, head_loss_pe_fn("quantiles"), cfg, opt)
    for _ in range(2):
        step(*tensors)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(*tensors)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = profiling.kernel_events(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    split = profiling.breakdown(kernels, STEPS)
    by_bucket = split["categories"]
    by_name: dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3 / STEPS
    busy_ms = profiling.union_ms(kernels)
    kernel_ms = split["total_ms"]
    return {
        "conv_backend": conv_backend, "compute_dtype": compute_dtype, "batch": BATCH, "image": IMAGE, "steps": STEPS,
        "device": torch.cuda.get_device_name(0), "wall_ms_per_step": wall_ms / STEPS,
        "busy_ms_per_step": busy_ms / STEPS, "idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_ms_per_step": kernel_ms,
        "buckets_ms_per_step": by_bucket,
        "bucket_shares": {k: v / kernel_ms for k, v in by_bucket.items()},
        "top_kernels_ms_per_step": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for backend, dtype in CASES:
        print(json.dumps(profile_backend(backend, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
