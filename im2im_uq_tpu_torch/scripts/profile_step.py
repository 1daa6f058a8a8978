"""Where a train step's device time goes, per ``conv_backend`` and compute dtype.

    python -m im2im_uq_tpu_torch.scripts.profile_step

For each backend of ``unet.CONV_BACKENDS``, in float32 and then in bfloat16
(``compute_dtype``): the full-width UNet + quantile head (random weights
from a seed) at batch 32, 320x320, TF32 off, two warm-up steps of
``make_train_step`` on one batch already on the card, then three steps
under ``torch.profiler``. Prints one JSON line per backend and dtype: the
wall time per step (host clock around the synchronized
steps), the device-busy time (the union of the kernels' intervals), the
idle share, and the kernel time per step in buckets (the port's kernels by
name; cuDNN's convolutions; BatchNorm; Adam; copies; the rest) with the ten
largest kernels. Needs a CUDA device; it does not fall back to the CPU.
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

__all__ = ["CASES", "bucket", "main", "profile_backend"]

BATCH, IMAGE, STEPS = 32, 320, 3
# (conv_backend, compute_dtype) in the order they are profiled
CASES = [(backend, dtype) for dtype in ("float32", "bfloat16") for backend in CONV_BACKENDS]

# (bucket, substrings of the kernel name), first match wins: the port's
# kernels first, since their names contain "conv" too
_BUCKETS = [
    # f32: conv3x3_fwd_kernel; bf16: conv3x3_fwd_wgmma_kernel (K6's body with
    # the forward's epilogue); the stem, conv3x3_fwd_stem_kernel
    ("K3/K4 conv3x3 (port)", ("conv3x3_fwd",)),
    # f32: wgrad3x3_tc_kernel; bf16: k5::wgrad_kernel and its stem (demangled
    # or mangled names)
    ("K5 wgrad3x3 (port)", ("wgrad3x3_tc_kernel", "k5::wgrad", "2k512wgrad_kernel",
                            "2k517wgrad_stem_kernel")),
    ("K6 dgrad3x3 (port)", ("dgrad3x3_tc_kernel", "k6::dgrad_kernel", "2k612dgrad_kernel")),
    # the bf16 GEMMs' operands: the NHWC activation (K3/K4's and K5's) and
    # cotangent passes, the packed weights of K3/K4 and K6
    ("bf16 packing (port)", ("nhwc_kernel", "pack_weights_k6")),
    ("fixed-order partial sums (port)", ("reduce_rows",)),
    # f32: upsample2x_kernel, upsample2x_bwd_kernel; bf16: the row-tiled
    # upsample2x_tile_kernel<V>, upsample2x_bwd_tile_kernel<V>
    ("K1f upsample (port)", ("upsample2x_kernel", "upsample2x_tile_kernel")),
    ("K1b upsample backward (port)", ("upsample2x_bwd_kernel", "upsample2x_bwd_tile_kernel")),
    ("K7 max-pool backward (port)", ("maxpool2x2_bwd_kernel",)),
    ("batchnorm (cuDNN / torch)", ("batch_norm", "bn_fw", "bn_bw", "welford", "bn_")),
    ("conv (cuDNN)", ("conv", "xmma", "implicit", "winograd", "fft", "cudnn", "gemm",
                      "cutlass", "flip_filter", "wgrad", "dgrad",
                      "pointwise_mult_and_sum_complex")),  # cuDNN's FFT convs
    ("Adam (foreach)", ("multi_tensor", "adam")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
]


def bucket(name: str) -> str:
    low = name.lower()
    for label, keys in _BUCKETS:
        if any(k in low for k in keys):
            return label
    return "other elementwise and reductions"


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


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
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    by_bucket: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_bucket[bucket(e.name)] = by_bucket.get(bucket(e.name), 0.0) + ms / STEPS
        by_name[e.name] = by_name.get(e.name, 0.0) + ms / STEPS
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    kernel_ms = sum(by_bucket.values())
    return {
        "conv_backend": conv_backend, "compute_dtype": compute_dtype, "batch": BATCH, "image": IMAGE, "steps": STEPS,
        "device": torch.cuda.get_device_name(0), "wall_ms_per_step": wall_ms / STEPS,
        "busy_ms_per_step": busy_ms / STEPS, "idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_ms_per_step": kernel_ms,
        "buckets_ms_per_step": dict(sorted(by_bucket.items(), key=lambda kv: -kv[1])),
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
