#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. env        versions of torch, CUDA and nvcc; the card's name and power
              limit; TF32 switched off for convolutions and matmuls.
2. build      compile ``im2im_uq_tpu_torch/csrc/*.cu`` (timed).
3. k1         the upsample kernel against its plain PyTorch version on the
              card, at the four decoder shapes of a batch-32 320x320 UNet
              and some odd shapes, in f32 and bf16, with both times.
   k1b        the upsample's backward kernel against its plain version at
              the four decoder cotangent shapes and the odd shapes, both
              dtypes, with both times.
4. k2         the loss-table kernel against its plain version, 0 cells
              apart and the same bits twice, at (32, 102400) and L=1000 on
              the calibration grid and on edge grids (unsorted, duplicates,
              negative, ±0, NaN, ±inf; slopes of both signs, ±0, ±inf, NaN;
              exact ties), the same at an odd P and at L=20000, with both
              times.
   k7         the max-pool backward kernel against its plain version and
              against autograd of ``F.max_pool2d``, bit for bit, at the four
              pool inputs of the batch-32 320x320 UNet, odd shapes and tied
              windows, both dtypes, with both times.
   k3..k6     the 3x3 conv kernels (K3 conv, K4 fused conv, K5 wgrad, K6
              dgrad) against their plain versions at every conv shape of a
              batch-32 320x320 UNet train step under ``pallas_fused`` and
              ``pallas``, odd shapes and batch 1; each run twice, bit for
              bit; kernel, plain, library and bound times at the main-path
              shapes, summed per step; then one conv_shape line per
              main-path shape with the K3-K6 times side by side (the stem
              marked).
   probes     P1 (per-channel moments) and P2-P5 (bias-free NHWC 3x3
              conv), the ports of the Pallas probes of ``benchmarks/``,
              against their plain versions in f32 and bf16 at the probes'
              default shape, at the shapes their CLIs run (which must take
              the bf16 TMA path) and at odd shapes (ragged tiles, Cin and
              Cout 8, 24 and 200, several N slices; Cin 3 and 5, Cout 7 on
              the cp.async path), each run twice, bit for bit; each line
              names its path; kernel, plain, library and bound times in
              both dtypes.
   probe_cli  the probes' CLIs (``scripts.bench_moments`` and
              ``scripts.bench_conv3x3`` at Cin 64, 128 and 96), which must
              launch P1-P5.
5. calibrate  the full-width UNet + quantile head (random weights from a
              seed) calibrated on 128 synthetic 320x320 images, L=1000.
6. serve      save the calibrated checkpoint, run ``scripts/infer.main`` on
              64 more images, check the intervals.
7. crosscheck the same model at batch 2 on the CPU (plain versions) and on
              the card, nested sets compared.
8. train      the full-width model at 320x320, batch 32, fp32: first
              ``make_train_step`` on one batch (every parameter's first
              gradient checked, the device time of 8 steps after 2
              warm-ups), then ``train_net`` from the same initial weights
              for one epoch of 384 synthetic images (12 steps) and its
              validation, with the launches of K1f, K1b and K7.
9. router     ``scripts/router.main`` on a copy of
              ``experiments/synthetic_test/config.yml`` writing to a
              temporary directory: artifacts, results keys, λ̂, launches.
10. gradcheck one train step of the phase-8 initial weights at batch 2,
              64x64: on the card with the kernels against the card with
              their plain versions (bit for bit), and against the CPU in
              f32 and f64: gradients and BatchNorm running statistics.
11. fused     the same model under ``conv_backend: pallas_fused`` at
              320x320, batch 32: ``make_train_step`` (first gradients, the
              step time), one step and the eval forward against the default
              (cuDNN) config from the same weights, then calibrate and serve
              as in phases 5-6 (fused_calibrate, fused_serve).
12. pallas    ``conv_backend: pallas``: one train step and the eval forward
              against the default config.
13. router    the router again, on the synthetic experiment with
              ``conv_backend: pallas_fused`` (router_fused).

The kernel launch counters are set to 0 just before each path that a user
runs (the probe CLIs, calibrate + serve, train, router, and each of them
under the fused config) and read just after it; the ``kernels`` line
reports the sum over those paths. Any failure raises and the script exits
non-zero. The line before the last is ``nvidia-smi``'s name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.calibration.rcps import calibrate_model, lambda_grid
from im2im_uq_tpu_torch.models.assembly import (
    UQState,
    add_uncertainty,
    build_trunk,
    nchw_from_nhwc,
)
from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
from im2im_uq_tpu_torch.ops import (
    conv,
    conv_bwd,
    conv_probe,
    loss_table,
    moments,
    pool,
    upsample,
)
from im2im_uq_tpu_torch.scripts import bench_conv3x3, bench_moments, infer, router
from im2im_uq_tpu_torch.training import train
from im2im_uq_tpu_torch.training.checkpoint import (
    calibrated_checkpoint_path,
    save_calibrated_checkpoint,
)
from im2im_uq_tpu_torch.utils.timing import time_ms

DECODER_SHAPES = [(32, 512, 20, 20), (32, 256, 40, 40), (32, 128, 80, 80), (32, 64, 160, 160)]
ODD_SHAPES = [(2, 3, 1, 1), (1, 5, 1, 7), (3, 7, 9, 1), (2, 4, 13, 17), (1, 2, 33, 5)]

CONFIG = {
    "model": "UNet",
    "uncertainty_type": "quantiles",
    "q_lo": 0.05,
    "q_hi": 0.95,
    "alpha": 0.1,
    "delta": 0.1,
    "num_lambdas": 1000,
    "minimum_lambda": 0.0,
    "maximum_lambda": 6.0,
    "rcps_loss": "fraction_missed",
    "batch_size": 32,
    "dataset": "synthetic",
    "lr": 1e-3,
}
CALIB_N, SERVE_N, IMAGE = 128, 64, 320
POOL_SHAPES = [(32, 64, 320, 320), (32, 128, 160, 160), (32, 256, 80, 80), (32, 512, 40, 40)]
POOL_ODD_SHAPES = [(2, 3, 5, 7), (1, 2, 1, 9)]
TRAIN_N, TRAIN_VAL_N, WARMUP_STEPS, TIMED_STEPS = 384, 32, 2, 8
# gradcheck tolerances, relative L2 per tensor (see phase_gradcheck)
GRAD_RTOL, STAT_RTOL = 1e-2, 1e-5
ROUTER_CONFIG = Path(__file__).resolve().parent / "experiments" / "synthetic_test" / "config.yml"
# the keys of the JAX router's results pickle (im2im_uq_tpu/scripts/router.py:299-308)
RESULT_KEYS = sorted([
    "risk", "sizes", "spearman", "size-stratified risk", "mse", "spatial_miscoverage",
    "lhat", "inputs", "gt", "predictions", "lower_edge", "upper_edge",
])
DEVICE = "cuda"  # where phases 8-10 run the port
# each kernel's wrapper, which counts its launches
KERNELS = {
    "upsample2x": upsample.upsample2x,
    "upsample2x_bwd": upsample.upsample2x_bwd,
    "loss_table": loss_table.loss_table,
    "maxpool2x2_bwd": pool.max_pool2x2_bwd,
    "conv3x3": conv.conv3x3,
    "conv3x3_bn_act": conv.conv3x3_bn_act,
    "wgrad3x3": conv_bwd.wgrad3x3,
    "dgrad3x3": conv_bwd.dgrad3x3,
    "moments": moments.moments,
    "conv3x3_single": conv_probe.conv3x3_single,
    "conv3x3_db": conv_probe.conv3x3_db,
    "conv3x3_l1": conv_probe.conv3x3_l1,
    "conv3x3_c64": conv_probe.conv3x3_c64,
}
PROBE_KERNELS = ["moments", "conv3x3_single", "conv3x3_db", "conv3x3_l1", "conv3x3_c64"]
DEFAULT_PATH_KERNELS = ["upsample2x", "upsample2x_bwd", "loss_table", "maxpool2x2_bwd"]
CONV_KERNELS = ["conv3x3", "conv3x3_bn_act", "wgrad3x3", "dgrad3x3"]
CONV_PHASES = dict(zip(CONV_KERNELS, ["k3", "k4", "k5", "k6"]))
# The DoubleConvs of the 320x320 UNet as (Cin, mid, Cout, side, in an Up):
# an Up's conv0 reads the concatenation of two halves of Cin // 2 channels
DOUBLE_CONVS = [
    (1, 64, 64, 320, False), (64, 128, 128, 160, False), (128, 256, 256, 80, False),
    (256, 512, 512, 40, False), (512, 512, 512, 20, False),
    (1024, 512, 256, 40, True), (512, 256, 128, 80, True), (256, 128, 64, 160, True),
    (128, 64, 64, 320, True),
]
# (B, Cin, H, W, Cout): Cin 1, 3 and 64, 1x1, 5x7 and 13x17, batch 1
CONV_ODD_SHAPES = [(2, 1, 1, 1, 8), (1, 3, 5, 7, 16), (2, 64, 13, 17, 24), (1, 1, 13, 17, 64),
                   (1, 64, 5, 7, 64), (1, 128, 160, 160, 128)]
# Bars of a conv kernel against its plain version, on the relative L2
# error and on max|error| / max|plain|: both sum in f32 in another order,
# over 9*Cin terms (K3, K4's y, K6's dx: 3e-5) or over B*H*W terms (K5,
# K4's stats, K6's reductions: 1e-4); a wrong tap or mask is off by order 1.
CONV_TOL, SUM_TOL = 3e-5, 1e-4
# the fused config's step against the default config's, same weights: the
# running statistics come from the forward alone; the eval forward too
FUSED_STAT_RTOL, FUSED_EVAL_RTOL, FUSED_LOSS_RTOL = 1e-4, 1e-4, 1e-4
# H100 SXM data sheet: fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# f32-accurate products on the tensor cores: TF32's 495 TFLOP/s (data
# sheet, dense) over the three passes of 3xTF32 (hi·hi + hi·lo + lo·hi)
PEAK_F32_TC_FLOPS = 495e12 / 3
# bf16 products on the tensor cores, f32 accumulation (H100 SXM data sheet,
# dense)
PEAK_BF16_TC_FLOPS = 989e12
# (B, Cin, H, W, Cout) of the Pallas probes' defaults: P1's x
# (benchmarks/bench_moments.py:28), P2-P5's conv
# (benchmarks/bench_pallas_conv.py:377-389)
PROBE_SHAPE = (32, 64, 320, 320, 64)
# P1's NHWC cases beyond PROBE_SHAPE: C 1, 3 and 96 over 100011 rows (which
# fill no block evenly), batch 1
MOMENT_ODD_SHAPES = [(3, 37, 901, 1), (3, 37, 901, 3), (3, 37, 901, 96), (1, 5, 7, 64)]
# P1's bars: each sum within 1e-5 of Σ|x| (Σx) or Σx² (Σx²) per channel; the
# mean within 1e-5, the variance within 1e-4·E[x²] (a mean of 3 makes
# Σx²/n − mean² cancel)
MOMENT_SUM_TOL, MOMENT_MEAN_ATOL, MOMENT_VAR_TOL = 1e-5, 1e-5, 1e-4
# (wrapper, (B, H, W, Cin, Cout)) of P2-P5's odd cases: Cin 128 for P2/P3,
# P4 at Cin 3 and 96 with H = 13, batch 1, 13x17 and 13x21 images (Cin 3,
# 5 and Cout 7 take the cp.async path in bf16 too); then ragged cases of
# the bf16 TMA path: H and W past whole tiles (13 and 70 against tiles of
# 4 or 8 rows x 64 pixels), Cin and Cout 8, 24 and 200 at batch 2, several
# N slices (Cout 200 and 40), every N width the plan picks (16, 32, 64, 96,
# 128), and images of one row or one column, smaller than a TMA box
CONV_PROBE_ODD = [("conv3x3_single", (1, 13, 17, 128, 128)), ("conv3x3_db", (2, 13, 17, 128, 64)),
                  ("conv3x3_l1", (2, 13, 17, 3, 32)), ("conv3x3_l1", (1, 13, 16, 96, 96)),
                  ("conv3x3_l1", (1, 5, 9, 5, 7)), ("conv3x3_c64", (1, 13, 21, 64, 40)),
                  ("conv3x3_l1", (2, 13, 70, 8, 8)), ("conv3x3_l1", (2, 13, 70, 24, 24)),
                  ("conv3x3_l1", (2, 13, 70, 200, 200)), ("conv3x3_l1", (2, 11, 130, 8, 200)),
                  ("conv3x3_single", (2, 11, 70, 128, 200)), ("conv3x3_db", (2, 9, 70, 96, 24)),
                  ("conv3x3_c64", (2, 13, 70, 64, 8)), ("conv3x3_c64", (2, 13, 70, 64, 128)),
                  ("conv3x3_l1", (1, 1, 1, 8, 16)), ("conv3x3_single", (1, 1, 300, 128, 8)),
                  ("conv3x3_l1", (2, 300, 1, 16, 8))]
# the shapes at which the probe CLIs (bench_conv3x3.main, bf16) run each
# wrapper: the main path's
CONV_PROBE_CLI = {"conv3x3_single": (32, 320, 320, 128, 128), "conv3x3_db": (32, 320, 320, 128, 128),
                  "conv3x3_l1": (32, 320, 320, 96, 96), "conv3x3_c64": (32, 320, 320, 64, 64)}
# f32 bar of P2-P5 (the probe's own, bench_pallas_conv.py:399)
CONV_PROBE_TOL = 2e-5


def conv_sites(conv_backend: str) -> dict:
    """The 3x3 conv launches of one train step at batch 32, 320x320 →
    {kernel: [((B, Cin, H, W, Cout), prologue), ...]}, one entry per launch.

    Under ``pallas`` every conv is K3. Under ``pallas_fused`` conv0 is K4
    without the prologue and conv1 K4 with bn0 as its prologue; K5 is the
    backward of every K4 launch, K6 of every one but the stem's (its input
    needs no gradient). Under both, an Up's conv0 is two K3 calls, one per
    half of the concatenation."""
    b = CONFIG["batch_size"]
    sites: dict = {k: [] for k in CONV_KERNELS}
    fused = conv_backend == "pallas_fused"
    for cin, mid, cout, side, up in DOUBLE_CONVS:
        def site(ci, co, prologue=False):
            return (b, ci, side, side, co), prologue
        if up:
            sites["conv3x3"] += [site(cin // 2, mid)] * 2
        else:
            sites["conv3x3_bn_act" if fused else "conv3x3"].append(site(cin, mid))
        if fused:
            sites["conv3x3_bn_act"].append(site(mid, cout, True))
        else:
            sites["conv3x3"].append(site(mid, cout))
    if fused:
        sites["wgrad3x3"] = list(sites["conv3x3_bn_act"])
        sites["dgrad3x3"] = sites["conv3x3_bn_act"][1:]
    return sites


def synthetic(num_examples: int, image_size: int, seed: int):
    """The router's synthetic dataset, every item made before it is timed."""
    ds = router.build_dataset({"dataset": "synthetic", "num_examples": num_examples,
                               "image_size": image_size, "seed": seed})
    for i in range(len(ds)):
        ds[i]
    return ds


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take for work of ``flops`` f32
    operations at ``peak`` FLOP/s on ``nbytes`` bytes each moved once, and
    which of the two bounds it."""
    ops_ms = 1e3 * flops / peak
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def add_bound(result: dict, flops: float, nbytes: float, times: int = 1,
              peak: float = PEAK_FP32_FLOPS) -> None:
    """Add one shape's bound (``times`` launches of it) to a kernel's sums."""
    ms, by = bound(flops, nbytes, peak)
    result["bound_ms"] = result.get("bound_ms", 0.0) + times * ms
    shares = result.setdefault("_bound_shares", {})
    shares[by] = shares.get(by, 0.0) + times * ms


def close_bound(result: dict) -> dict:
    """bound_by: the bound that holds for most of the summed bound time."""
    shares = result.pop("_bound_shares")
    result["bound_by"] = max(shares, key=shares.get)
    return result


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def require_launches(phase: str, counts: dict, names) -> None:
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{phase}: kernels not on the path: {missing} ({counts})")


def phase_env() -> str:
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(
        "env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc, card=smi,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
    )
    return smi


def phase_build() -> None:
    info = _build.build()
    _build.library()
    usage = [ln.strip() for ln in info.log.splitlines() if "Used" in ln]
    emit("build", compiled=info.compiled, seconds=info.seconds, library=str(info.path),
         ptxas=usage)


def phase_k1() -> dict:
    """K1 vs plain: f32 within 1e-6·max|x|; bf16 within one bf16 ulp of the
    plain result computed in f32 from the same bf16 input and rounded once."""
    g = torch.Generator(device="cuda").manual_seed(1)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in DECODER_SHAPES + ODD_SHAPES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            got = upsample.upsample2x(x)
            want = upsample.upsample2x_plain(x)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                tol = 1e-6 * x.abs().max().item()
                ok = diff.max().item() <= tol
            else:
                tol = conv_probe.bf16_ulp(want)
                ok = bool((diff <= tol).all())
                tol = tol.max().item()
            if not ok:
                raise AssertionError(
                    f"K1 disagrees with its plain version at {shape} {dtype}: "
                    f"max abs err {diff.max().item()} > tol {tol}"
                )
            fields = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": diff.max().item(), "tol": tol}
            if shape in DECODER_SHAPES:
                fields["ms"] = time_ms(lambda: upsample.upsample2x(x), 20)
                fields["plain_ms"] = time_ms(lambda: upsample.upsample2x_plain(x), 5)
                fields["library_ms"] = time_ms(lambda: F.interpolate(
                    x, scale_factor=2, mode="bilinear", align_corners=True), 20)
                if dtype == torch.float32:  # the main path's dtype
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms"):
                        result[k] += fields[k]
                    # 3 lerps of 2 operations per output; x read, y written
                    add_bound(result, 6 * 4 * x.numel(), 4 * 5 * x.numel())
            emit("k1", **fields)
    return close_bound(result)


def _k2_maps(n: int, p: int, gen: torch.Generator, signed: bool) -> tuple:
    """(pred, label, dl, du) on the card: residuals of both signs, slopes in
    [0.05, 0.5] with rows of zero slopes; ``signed``: slopes of both signs,
    ±0, ±inf and NaN, and residuals inside the 1e-6 guard."""
    pred = torch.rand((n, p), generator=gen, device="cuda")
    label = pred + 0.3 * torch.randn((n, p), generator=gen, device="cuda")
    dl = 0.05 + 0.45 * torch.rand((n, p), generator=gen, device="cuda")
    du = 0.05 + 0.45 * torch.rand((n, p), generator=gen, device="cuda")
    dl[0, :1000] = 0.0  # zero slopes: missed at every finite λ where the guard passes
    du[min(1, n - 1), :1000] = 0.0
    if signed:
        for slope in (dl, du):
            pick = torch.randint(0, 10, (n, p), generator=gen, device="cuda")
            slope[pick < 4] *= -1.0
            for v, special in enumerate([0.0, -0.0, float("inf"), -float("inf"), float("nan")]):
                slope[pick == 4 + v] = special
        label[:, :7] = pred[:, :7] - 5e-7
    return pred, label, dl, du


def _k2_ties(n: int, p: int, lam: torch.Tensor, gen: torch.Generator) -> tuple:
    """Maps whose residual is exactly λ·s for a finite λ of the grid."""
    finite = lam[torch.isfinite(lam)]
    s = 0.5 + torch.randint(0, 8, (n, p), generator=gen, device="cuda").float() / 16
    r = (finite[torch.randint(0, finite.numel(), (n, p), generator=gen, device="cuda")] * s).abs()
    side = torch.rand((n, p), generator=gen, device="cuda") < 0.5
    return torch.where(side, r, -r), torch.zeros_like(r), s, s.clone()


def _k2_grids(lam: torch.Tensor, gen: torch.Generator) -> dict:
    """The calibration grid and the edge grids of the same length."""
    num = lam.numel()
    perm = torch.randperm(num, generator=gen, device="cuda")
    special = lam[perm].clone()
    special[:12] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0,
                                 float("nan"), 0.0, -0.0, float("inf"), -1.5, -0.25, 2.0],
                                device="cuda")
    return {
        "grid": lam,
        "unsorted": lam[perm],
        "duplicates": lam[torch.randint(0, num // 4, (num,), generator=gen, device="cuda")],
        "negative": torch.linspace(-6.0, 6.0, num, device="cuda")[perm],
        "zeros_nan_inf": special,
    }


def phase_k2(lam) -> dict:
    """K2 vs plain: the same table bit for bit (its counts are integers) and
    the same bits twice, at the main path's (32, 102400) and L = 1000 on the
    calibration grid and on edge grids (unsorted, duplicates, negative, ±0
    with NaN and ±inf), with slopes of both signs, ±0, ±inf and NaN and with
    exact ties λ·s == r; the same at an odd P, and at L = 20000, whose
    bins do not fit shared memory. Timed on the calibration grid."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, p = 32, IMAGE * IMAGE
    cases = []
    for shape in [(n, p), (5, 1001)]:
        grids = _k2_grids(lam, gen)
        for name, grid in grids.items():
            cases.append((shape, name, "default", _k2_maps(*shape, gen, False), grid))
            cases.append((shape, name, "signed", _k2_maps(*shape, gen, True), grid))
        cases.append((shape, "grid", "ties", _k2_ties(*shape, grids["grid"], gen), grids["grid"]))
        cases.append((shape, "negative", "ties", _k2_ties(*shape, grids["negative"], gen),
                      grids["negative"]))
    wide = torch.linspace(-3.0, 3.0, 20000, device="cuda")
    wide = wide[torch.randperm(wide.numel(), generator=gen, device="cuda")]
    cases.append(((3, 1001), "wide_20000", "signed", _k2_maps(3, 1001, gen, True), wide))
    for (cn, cp), grid_name, maps_name, maps, grid in cases:
        got = loss_table.loss_table(*maps, grid)
        again = loss_table.loss_table(*maps, grid)
        want = loss_table.loss_table_plain(*maps, grid)
        torch.cuda.synchronize()
        differ = int((got != want).sum().item())
        if differ or not torch.equal(got, again):
            raise AssertionError(f"K2 at {(cn, cp)}, grid {grid_name}, maps {maps_name}: "
                                 f"{differ} cells differ from the plain version, "
                                 f"the same bits twice: {torch.equal(got, again)}")
        emit("k2", shape=[cn, cp], num_lambdas=int(grid.numel()), grid=grid_name,
             maps=maps_name, cells_differ=differ, cells=got.numel(), bit_identical=True)
    pred, label, dl, du = cases[0][3]
    ms = time_ms(lambda: loss_table.loss_table(pred, label, dl, du, lam), 50)
    plain_ms = time_ms(lambda: loss_table.loss_table_plain(pred, label, dl, du, lam), 2)
    num_lam = int(lam.shape[0])
    # the four maps read once, the table written once; brute_force_ms: the
    # first design's two multiplies and two compares per (pixel, λ) at the
    # f32 peak. No single PyTorch call computes the table: library_ms is null.
    result = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "brute_force_ms": bound(4 * n * p * num_lam, 0)[0]}
    add_bound(result, 0, 4 * (4 * n * p + num_lam + n * num_lam))
    emit("k2", shape=[n, p], num_lambdas=num_lam, ms=ms, plain_ms=plain_ms,
         bound_ms=result["bound_ms"], brute_force_ms=result["brute_force_ms"])
    return close_bound(result)


def phase_k1b() -> dict:
    """K1b vs plain: f32 within 4e-6·max|g| (each dx sums up to 16 taps
    whose weights add up to about 4, so this is a few f32 ulps); bf16
    within one bf16 ulp of the plain result computed in f32 and rounded
    once. Shapes are those of dx (the upsample's input)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, h, w in DECODER_SHAPES + ODD_SHAPES:
            g = torch.randn((b, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
            got = upsample.upsample2x_bwd(g)
            want = upsample.upsample2x_bwd_plain(g)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                tol = 4e-6 * g.abs().max().item()
                ok = diff.max().item() <= tol
            else:
                tol = conv_probe.bf16_ulp(want)
                ok = bool((diff <= tol).all())
                tol = tol.max().item()
            if not ok:
                raise AssertionError(
                    f"K1b disagrees with its plain version at {tuple(g.shape)} {dtype}: "
                    f"max abs err {diff.max().item()} > tol {tol}"
                )
            fields = {"cotangent": list(g.shape), "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": diff.max().item(), "tol": tol}
            if (b, c, h, w) in DECODER_SHAPES:
                fields["ms"] = time_ms(lambda: upsample.upsample2x_bwd(g), 20)
                fields["plain_ms"] = time_ms(lambda: upsample.upsample2x_bwd_plain(g), 5)
                # the backward of F.interpolate, which autograd would call
                fields["library_ms"] = time_ms(
                    lambda: torch.ops.aten.upsample_bilinear2d_backward(
                        g, [2 * h, 2 * w], [b, c, h, w], True), 20)
                if dtype == torch.float32:  # the main path's dtype
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms"):
                        result[k] += fields[k]
                    # each cotangent element feeds 4 inputs: 4 multiply-adds
                    add_bound(result, 8 * g.numel(), 4 * (g.numel() + b * c * h * w))
            emit("k1b", **fields)
    return close_bound(result)


def torch_pool_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx of ``F.max_pool2d(x, 2)`` by torch's autograd; zeros where torch
    refuses to pool (H or W < 2), since then nothing is pooled."""
    if min(x.shape[-2:]) < 2:
        return torch.zeros_like(x)
    xr = x.detach().clone().requires_grad_()
    F.max_pool2d(xr, 2).backward(g)
    return xr.grad


def phase_k7() -> dict:
    """K7 vs its plain version and vs torch's autograd of F.max_pool2d:
    bit-identical (it moves values and does no arithmetic)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    cases = [(s, "randn") for s in POOL_SHAPES + POOL_ODD_SHAPES]
    cases += [((2, 8, 6, 10), "constant"), ((2, 8, 6, 10), "zero_one")]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, kind in cases:
            if kind == "randn":
                x = torch.randn(shape, generator=gen, device="cuda")
            elif kind == "constant":  # every window is a four-way tie
                x = torch.ones(shape, device="cuda")
            else:  # ties between some of the elements of most windows
                x = torch.randint(0, 2, shape, generator=gen, device="cuda").float()
            x = x.to(dtype)
            b, c, h, w = shape
            g = torch.randn((b, c, h // 2, w // 2), generator=gen, device="cuda").to(dtype)
            got = pool.max_pool2x2_bwd(x, g)
            plain = pool.max_pool2x2_bwd_plain(x, g)
            ref = torch_pool_grad(x, g)
            torch.cuda.synchronize()
            if not (torch.equal(got, plain) and torch.equal(got, ref)):
                raise AssertionError(
                    f"K7 disagrees at {shape} {kind} {dtype}: plain {torch.equal(got, plain)}, "
                    f"autograd {torch.equal(got, ref)}"
                )
            fields = {"shape": list(shape), "input": kind, "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": (got.float() - plain.float()).abs().max().item()
                      if got.numel() else 0.0}
            if shape in POOL_SHAPES:
                _, idx = F.max_pool2d(x, 2, return_indices=True)
                fields["ms"] = time_ms(lambda: pool.max_pool2x2_bwd(x, g), 20)
                fields["plain_ms"] = time_ms(lambda: pool.max_pool2x2_bwd_plain(x, g), 5)
                # torch's own max-pool backward (given its forward's indices)
                fields["library_ms"] = time_ms(
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        g, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx), 20)
                if dtype == torch.float32:
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms"):
                        result[k] += fields[k]
                    # three compares per window; x and g read, dx written
                    add_bound(result, 3 * g.numel(), 4 * (2 * x.numel() + g.numel()))
            emit("k7", **fields)
    return close_bound(result)


def _conv_case(b: int, cin: int, h: int, w: int, cout: int, gen: torch.Generator) -> dict:
    """Inputs of one conv shape: weights at torch's init scale, scale > 0 and
    shift > 0 for the prologue (a prologue leaking into the zero frame
    shows), a random cotangent."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    return {"x": randn(b, cin, h, w), "w": randn(cout, cin, 3, 3) / (9 * cin) ** 0.5,
            "bias": 0.1 * randn(cout), "scale": 0.5 + rand(cin), "shift": 0.05 + 0.3 * rand(cin),
            "g": randn(b, cout, h, w)}


def _conv_calls(kernel: str, c: dict, prologue: bool):
    """(kernel call, plain call, library call, bars per output, bytes moved)
    of one conv kernel on the inputs ``c``. The library call computes the
    conv part alone: cuDNN has no fused prologue, stats or mask."""
    x, w, bias, sc, sh, g = (c[k] for k in ("x", "w", "bias", "scale", "shift", "g"))
    n = 4  # bytes per float
    if kernel == "conv3x3":
        return (lambda: (conv.conv3x3_fwd(x, w, bias),),
                lambda: (conv.conv3x3_plain(x, w, bias),),
                lambda: F.conv2d(x, w, bias, padding=1), [CONV_TOL],
                n * (x.numel() + w.numel() + bias.numel() + g.numel()))
    if kernel == "conv3x3_bn_act":
        return (lambda: conv.conv3x3_bn_act_fwd(x, w, bias, sc, sh, prologue, True),
                lambda: conv.conv3x3_bn_act_plain(x, w, bias, sc, sh, prologue, True),
                lambda: F.conv2d(x, w, bias, padding=1), [CONV_TOL, SUM_TOL],
                n * (x.numel() + w.numel() + bias.numel() + 2 * sc.numel() + g.numel()
                     + 2 * g.shape[0] * g.shape[1]))
    if kernel == "wgrad3x3":
        a = conv_bwd.prologue_activation(x, sc, sh, prologue)
        return (lambda: conv_bwd.wgrad3x3(x, g, sc, sh, prologue),
                lambda: conv_bwd.wgrad3x3_plain(x, g, sc, sh, prologue),
                lambda: torch.nn.grad.conv2d_weight(a, w.shape, g, padding=1),
                [SUM_TOL, SUM_TOL],
                n * (x.numel() + g.numel() + w.numel() + bias.numel() + 2 * sc.numel()))
    return (lambda: conv_bwd.dgrad3x3(g, x, w, sc, sh, prologue),
            lambda: conv_bwd.dgrad3x3_plain(g, x, w, sc, sh, prologue),
            lambda: torch.nn.grad.conv2d_input(x.shape, w, g, padding=1), [CONV_TOL, SUM_TOL],
            n * (g.numel() + w.numel() + 2 * x.numel() + 4 * sc.numel()))


def _conv_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max |error|, relative L2 error, max |error| / max |want|)."""
    diff = (got.double() - want.double())
    ref = want.double()
    scale_l2, scale_max = ref.norm().item(), ref.abs().max().item()
    max_abs = diff.abs().max().item() if diff.numel() else 0.0
    rel_l2 = diff.norm().item() / scale_l2 if scale_l2 > 0 else diff.norm().item()
    rel_max = max_abs / scale_max if scale_max > 0 else max_abs
    return max_abs, rel_l2, rel_max


def conv_bound(shape: tuple, nbytes: float,
               peak: float = PEAK_F32_TC_FLOPS) -> tuple[float, str, float]:
    """(bound ms, what bounds it, a direct conv's operations) of one 3x3
    conv kernel at ``shape`` = (B, Cin, H, W, Cout).

    A direct conv does 9 multiply-adds per (output, channel pair). The
    bound counts 1, the limit of Winograd F(m×m, 3×3) ((m+2)² products per
    m² outputs) as m grows, which no algorithm in use for the conv or its
    gradients beats (F(4×4, 3×3) needs 2.25, an FFT more than 1), the
    transforms not counted, at the card's f32-accurate rate, 3xTF32 on the
    tensor cores (PEAK_F32_TC_FLOPS; ``peak``, PEAK_BF16_TC_FLOPS for bf16
    operands): Winograd's product stage is a batched GEMM, which runs there
    too."""
    b, cin, h, w, cout = shape
    direct = 2.0 * b * h * w * cin * cout * 9
    ms, by = bound(direct / 9, nbytes, peak)
    return ms, by, direct


def phase_conv_kernels() -> dict:
    """K3-K6 against their plain versions on the card, with TF32 off.

    Every conv launch of the batch-32 320x320 train step under
    ``pallas_fused`` and ``pallas`` (``conv_sites``) and the odd shapes,
    prologue on and off where the kernel has one; each kernel run twice
    must give the same bits (no atomics); K4 without the stats (its eval
    form) must give the same y as with them. At the main-path shapes the
    kernel, plain and library times (CUDA events) and the bound, summed over
    each step's launches: the ``pallas_fused`` step's sums are the
    ``kernels`` line's; K3's sums over the ``pallas`` step are the
    ``k3_pallas_step`` line.
    """
    gen = torch.Generator(device="cuda").manual_seed(7)
    steps = {backend: conv_sites(backend) for backend in ("pallas_fused", "pallas")}
    results = {}
    per_shape: dict = {}  # (shape, prologue) -> {kernel phase: ms}
    for kernel in CONV_KERNELS:
        counts = {backend: collections.Counter(sites[kernel])
                  for backend, sites in steps.items() if sites[kernel]}
        main = list(dict.fromkeys(case for c in counts.values() for case in c))
        prologues = [False] if kernel == "conv3x3" else [True, False]
        cases = main + [(shape, p) for shape in CONV_ODD_SHAPES for p in prologues]
        sums = {backend: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
                for backend in counts}
        for (shape, prologue) in cases:
            b, cin, h, w, cout = shape
            c = _conv_case(b, cin, h, w, cout, gen)
            run, plain, library, bars, nbytes = _conv_calls(kernel, c, prologue)
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{kernel} {shape} prologue={prologue}: two runs differ")
            errs = [_conv_errors(a, b_) for a, b_ in zip(got, want)]
            fields = {"shape": list(shape), "prologue": prologue,
                      "max_abs_err": [e[0] for e in errs], "rel_l2_err": [e[1] for e in errs],
                      "rel_max_err": [e[2] for e in errs], "bars": bars, "bit_identical": True}
            if kernel == "conv3x3_bn_act":
                y_eval, _ = conv.conv3x3_bn_act_fwd(c["x"], c["w"], c["bias"], c["scale"],
                                                    c["shift"], prologue, False)
                if not torch.equal(y_eval, got[0]):
                    raise AssertionError(f"K4 {shape}: y without the stats differs")
            bad = [i for i, (e, bar) in enumerate(zip(errs, bars)) if max(e[1], e[2]) > bar]
            if bad:
                raise AssertionError(f"{kernel} {shape} prologue={prologue} disagrees with its "
                                     f"plain version in outputs {bad}: {fields}")
            if (shape, prologue) in main:
                fields["launches_per_step"] = {k: n[(shape, prologue)] for k, n in counts.items()
                                               if n[(shape, prologue)]}
                fields["ms"] = time_ms(run, 5)
                fields["plain_ms"] = time_ms(plain, 2)
                fields["library_ms"] = time_ms(library, 5)
                fields["bound_ms"], fields["bound_by"], direct = conv_bound(shape, nbytes)
                fields["direct_flop_ms"] = 1e3 * direct / PEAK_F32_TC_FLOPS
                fields["direct_tflops"] = direct / fields["ms"] / 1e9
                per_shape.setdefault((shape, prologue), {})[CONV_PHASES[kernel]] = fields["ms"]
                for backend, n in fields["launches_per_step"].items():
                    result = sums[backend]
                    result["max_abs_err"] = max(result["max_abs_err"], *fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms"):
                        result[k] += n * fields[k]
                    add_bound(result, direct / 9, nbytes, n, PEAK_F32_TC_FLOPS)
            emit(CONV_PHASES[kernel], **fields)
            del c, got, again, want
        results[kernel] = close_bound(sums["pallas_fused"])
        if "pallas" in sums:
            emit("k3_pallas_step", launches_per_step=sum(counts["pallas"].values()),
                 **close_bound(sums["pallas"]))
    for (shape, prologue), times in per_shape.items():
        emit("conv_shape", shape=list(shape), prologue=prologue, stem=shape[1] == 1,
             **{f"{k}_ms": times.get(k) for k in CONV_PHASES.values()})
    return results


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _moments_case(shape: tuple, dtype: torch.dtype, gen: torch.Generator, timed: bool) -> dict:
    """P1 against its plain version at one NHWC shape (x = N(3, 1)): the
    (2, C) sums, the mean and the variance each within their bars, the
    kernel's sums the same bits twice; with ``timed`` the kernel's, plain
    version's and library call's times and the bound."""
    x = (torch.randn(shape, generator=gen, device="cuda") + 3.0).to(dtype)
    n = x.numel() // shape[-1]
    got, again = moments.moment_sums(x), moments.moment_sums(x)
    want = moments.moment_sums_plain(x)
    x32 = x.float().reshape(n, -1)
    scale = torch.stack([x32.abs().sum(0), (x32 * x32).sum(0)])
    (m, v), (pm, pv) = moments.finish(got, n), moments.finish(want, n)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"moments {shape} {dtype}: two runs differ")
    sum_err = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
    mean_err = (m - pm).abs().max().item()
    ex2 = (scale[1] / n).max().item()
    var_err = (v - pv).abs().max().item()
    fields = {"kernel": "moments", "shape": list(shape), "dtype": _dtype_name(dtype),
              "max_abs_err": (got - want).abs().max().item(), "sum_rel_err": sum_err,
              "mean_abs_err": mean_err, "var_abs_err": var_err, "bit_identical": True,
              "bars": [MOMENT_SUM_TOL, MOMENT_MEAN_ATOL, MOMENT_VAR_TOL * ex2]}
    if sum_err > MOMENT_SUM_TOL or mean_err > MOMENT_MEAN_ATOL or var_err > MOMENT_VAR_TOL * ex2:
        raise AssertionError(f"P1 disagrees with its plain version: {fields}")
    if timed:
        fields["ms"] = time_ms(lambda: moments.moments(x), 20)
        fields["plain_ms"] = time_ms(lambda: moments.moments_plain(x), 5)
        fields["library_ms"] = time_ms(lambda: bench_moments.library_moments(x), 20)
        # an add, a multiply and an add per element; x read, 2C sums written
        fields["bound_ms"], fields["bound_by"] = bound(
            3 * x.numel(), x.numel() * x.element_size() + 8 * shape[-1])
    emit("probes", **fields)
    return fields


def _conv_probe_case(name: str, shape: tuple, dtype: torch.dtype, gen: torch.Generator,
                     timed: bool) -> dict:
    """One of P2-P5 against ``conv3x3_nobias_plain`` at (B, H, W, Cin,
    Cout): f32 within CONV_PROBE_TOL relative and absolute; bf16 within
    ``conv_probe.bf16_tolerance``: one bf16 ulp of the plain value plus the
    f32 sums' worst-case difference between two orders, 2·K·2^-24·Σ|x||w|
    (K = 9·Cin), which only matters where the sum cancels to near zero; the
    same bits twice."""
    b, h, w, cin, cout = shape
    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    fn = KERNELS[name]
    got, again = fn(x, k), fn(x, k)
    want = conv_probe.conv3x3_nobias_plain(x, k)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {shape} {dtype}: two runs differ")
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        tol = CONV_PROBE_TOL * (1.0 + want.abs())
    else:
        tol = conv_probe.bf16_tolerance(x, k, want)
    worst = (diff / tol).max().item()
    fields = {"kernel": name, "shape": list(shape), "dtype": _dtype_name(dtype),
              "path": "tma" if conv_probe.uses_tma(x, k) else "cp_async",
              "max_abs_err": diff.max().item(), "err_over_bar": worst, "bit_identical": True}
    if worst > 1.0:
        raise AssertionError(f"{name} disagrees with its plain version: {fields}")
    if timed:
        x_lib = x.permute(0, 3, 1, 2)  # NCHW channels_last: the same memory
        w_lib = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        fields["ms"] = time_ms(lambda: fn(x, k), 10)
        fields["plain_ms"] = time_ms(lambda: conv_probe.conv3x3_nobias_plain(x, k), 3)
        fields["library_ms"] = time_ms(lambda: F.conv2d(x_lib, w_lib, padding=1), 10)
        peak = PEAK_F32_TC_FLOPS if dtype == torch.float32 else PEAK_BF16_TC_FLOPS
        nbytes = (x.numel() + k.numel() + got.numel()) * x.element_size()
        fields["bound_ms"], fields["bound_by"], _ = conv_bound((b, cin, h, w, cout), nbytes, peak)
    emit("probes", **fields)
    del x, k, got, again, want, diff, tol
    return fields


def phase_probes() -> dict:
    """P1-P5 against their plain versions on the card, TF32 off, each run
    twice for the same bits.

    P1 at the probe's x (PROBE_SHAPE in NHWC) and MOMENT_ODD_SHAPES; P2-P5
    at PROBE_SHAPE, at the shapes their CLI runs them (CONV_PROBE_CLI) and
    at CONV_PROBE_ODD; every case in f32 and bf16. Timed: PROBE_SHAPE in
    both dtypes, the CLI shapes in bf16 (the CLI's dtype). → the ``kernels``
    line's rows: P1 summed over one call in each dtype at PROBE_SHAPE (what
    one pass of its CLI runs), P2-P5 at their CLI shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, cin, h, w, cout = PROBE_SHAPE
    results = {}
    p1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(b, h, w, cin)] + MOMENT_ODD_SHAPES:
            f = _moments_case(shape, dtype, gen, shape == (b, h, w, cin))
            if "ms" in f:  # the error of P1's outputs, the mean and the variance
                p1["max_abs_err"] = max(p1["max_abs_err"], f["mean_abs_err"], f["var_abs_err"])
                for key in ("ms", "plain_ms", "library_ms"):
                    p1[key] += f[key]
                size = torch.empty((), dtype=dtype).element_size()
                add_bound(p1, 3 * b * h * w * cin, size * b * h * w * cin + 8 * cin)
    results["moments"] = close_bound(p1)
    for dtype in (torch.float32, torch.bfloat16):
        for name in PROBE_KERNELS[1:]:
            cases = [(b, h, w, cin, cout)] + [s for n, s in CONV_PROBE_ODD if n == name]
            if dtype == torch.bfloat16 and CONV_PROBE_CLI[name] not in cases:
                cases.append(CONV_PROBE_CLI[name])
            for shape in cases:
                timed = shape == (b, h, w, cin, cout) or (
                    dtype == torch.bfloat16 and shape == CONV_PROBE_CLI[name])
                f = _conv_probe_case(name, shape, dtype, gen, timed)
                if dtype == torch.bfloat16 and shape == CONV_PROBE_CLI[name]:
                    if f["path"] != "tma":
                        raise AssertionError(f"{name} at its CLI shape ran {f['path']}, not tma")
                    results[name] = {k: f[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                       "library_ms", "bound_ms", "bound_by")}
    return results


def phase_probe_cli() -> dict:
    """The probes' CLIs as a user runs them on the card: ``bench_moments``
    (f32 and bf16 at the probe's x) and ``bench_conv3x3`` at its default
    (bf16, Cin = Cout = 64: P5), at Cin 128 (P2 and P3) and at Cin 96 (P4),
    each of which holds its kernels to a reference itself. → launches."""
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rcs = [bench_moments.main([]), bench_conv3x3.main([]),
               bench_conv3x3.main(["32", "320", "128", "128"]),
               bench_conv3x3.main(["32", "320", "96", "96"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if any(rcs):
        raise AssertionError(f"probe CLIs returned {rcs}")
    require_launches("probe_cli", counts, PROBE_KERNELS)
    emit("probe_cli", seconds=wall, output=out.getvalue().splitlines(), launches=counts)
    return counts


class RecordLog:
    """The logger ``train_net`` writes to, keeping its records."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, record: dict) -> None:
        self.records.append(dict(record))


def phase_train(config: dict) -> tuple[dict, dict, dict]:
    """One epoch of ``train_net`` at 320x320, batch 32 → (launches, the
    initial state dict, the train config).

    Before it, ``make_train_step`` on the same model and its first batch:
    every parameter's first gradient is checked, and after WARMUP_STEPS
    the device time of TIMED_STEPS steps is taken with CUDA events. The
    initial weights are then restored, so ``train_net`` starts from them.
    """
    cfg = dict(config, epochs=1)
    t0 = time.perf_counter()
    train_ds = synthetic(TRAIN_N, IMAGE, seed=2)
    val_ds = synthetic(TRAIN_VAL_N, IMAGE, seed=3)
    data_s = time.perf_counter() - t0
    state = add_uncertainty(
        build_trunk(cfg), cfg,
        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
    )
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    bs = cfg["batch_size"]
    batch = train.put_batch(np.stack([train_ds[i][0] for i in range(bs)]),
                            np.stack([train_ds[i][1] for i in range(bs)]),
                            np.ones((bs,), np.float32), torch.device(DEVICE))
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(state.model, head_loss_pe_fn(state.uncertainty_type), cfg, opt)
    losses = [float(step(*batch))]
    bad = [n for n, p in state.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
    if bad:
        raise AssertionError(f"after step 1, gradients missing, not finite or zero: {bad}")
    for _ in range(WARMUP_STEPS - 1):
        losses.append(float(step(*batch)))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    events[0].record()
    for e in events[1:]:
        step(*batch)
        e.record()
    events[-1].synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses.append(float(step(*batch)))
    state.model.load_state_dict(init)
    del opt, step, batch

    log = RecordLog()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.train_net(state, train_ds, val_ds, None, epochs=1, batch_size=bs, lr=cfg["lr"],
                    validate_every=1, config=cfg, logger=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require_launches("train", counts, ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"])
    epoch = {k: v for r in log.records for k, v in r.items()}
    if epoch["iter"] != TRAIN_N // bs:
        raise AssertionError(f"train took {epoch['iter']} steps, not {TRAIN_N // bs}")
    if not np.isfinite(losses + [epoch["train_loss"], epoch["val_loss"]]).all():
        raise AssertionError(f"train losses not finite: {losses} {epoch}")
    median_ms = float(np.median(step_ms))
    train_s = epoch["time/epoch_s"] - epoch["time/val_s"] - epoch["time/checkpoint_s"]
    emit("train", images=TRAIN_N, batch=bs, image=IMAGE, steps=epoch["iter"],
         median_step_ms=median_ms, imgs_per_sec=1e3 * bs / median_ms, step_ms=step_ms,
         step_losses=losses, epoch_imgs_per_sec=TRAIN_N / train_s, epoch=epoch,
         seconds=wall, data_seconds=data_s,
         params_with_gradient=sum(1 for _ in state.model.parameters()), launches=counts)
    return counts, init, cfg


def _feeds_batchnorm(name: str) -> bool:
    """A conv bias that a BatchNorm follows (DoubleConv's convs 0 and 3)."""
    return re.search(r"double_conv\.[03]\.bias$", name) is not None


def _train_step_once(init: dict, cfg: dict, device: str, dtype: torch.dtype, batch) -> tuple:
    """One train step of ``init`` on ``device`` in ``dtype`` → (loss,
    gradients, BatchNorm running statistics), as f64 CPU tensors."""
    st = add_uncertainty(build_trunk(cfg), cfg, device=device)
    st.model.load_state_dict(init)
    st.model.to(dtype)
    opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(st.model, head_loss_pe_fn(st.uncertainty_type), cfg, opt)
    x, y, mask = (t.to(dtype) for t in train.put_batch(*batch, torch.device(device)))
    loss = float(step(x, y, mask))
    grads = {n: p.grad.detach().double().cpu() for n, p in st.model.named_parameters()}
    stats = {n: b.detach().double().cpu() for n, b in st.model.named_buffers() if "running" in n}
    return loss, grads, stats


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms, so that two steps on
    the same inputs round alike."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def plain_versions():
    """The kernels' plain versions in place of their wrappers, on the card:
    the reference for the kernels' step. Nothing is counted."""
    saved = (upsample.upsample2x_fwd, upsample.upsample2x_bwd, pool.max_pool2x2_bwd)
    upsample.upsample2x_fwd = upsample.upsample2x_plain
    upsample.upsample2x_bwd = upsample.upsample2x_bwd_plain
    pool.max_pool2x2_bwd = pool.max_pool2x2_bwd_plain
    try:
        yield
    finally:
        upsample.upsample2x_fwd, upsample.upsample2x_bwd, pool.max_pool2x2_bwd = saved


def _rel_errors(got: dict, want: dict) -> dict:
    """Relative L2 error per tensor. A conv bias that a BatchNorm follows
    has an exact gradient of 0 (train-mode BatchNorm subtracts the batch
    mean), so every side holds rounding noise there: its error is taken
    relative to the same conv's weight gradient instead."""
    out = {}
    for n, w in want.items():
        ref = want[n[: -len("bias")] + "weight"] if _feeds_batchnorm(n) else w
        out[n] = ((got[n] - w).norm() / ref.norm()).item()
    return out


def _differ(a: tuple, b: tuple) -> list:
    """The names of the gradients and statistics that are not bit-identical."""
    return [n for part in (1, 2) for n in a[part] if not torch.equal(a[part][n], b[part][n])]


def phase_gradcheck(init: dict, cfg: dict) -> None:
    """One train step of the same weights (batch 2, 64x64): on the card
    with the kernels, on the card with their plain versions, on the CPU
    (plain versions) in f32 and on the CPU in f64.

    - The kernels against the plain versions on the card, with cuDNN held
      to deterministic algorithms: the loss, every gradient and every
      BatchNorm statistic bit-identical. The kernels are exact, so any
      difference is a fault on the gradient path.
    - The card (cuDNN's default algorithms) against the CPU's f32 step and
      the f64 step: relative L2 error per tensor ≤ GRAD_RTOL, BatchNorm
      running statistics ≤ STAT_RTOL. The step's gradient is a
      discontinuous function of its input (ReLU, max-pool and pinball
      kinks, amplified by train-mode BatchNorm over 2 images): one f32 ulp
      on every input pixel moves the f64 step's gradients by up to 2.1e-3
      per tensor, and the card's f32 step, with or without cuDNN, lands
      2.7e-3 to 3.1e-3 from the f64 one. A wrong or missing gradient path
      is off by order 1. The running statistics come from the forward
      alone (about 1e-6).
    """
    ds = synthetic(2, 64, seed=6)
    batch = (np.stack([ds[i][0] for i in range(2)]), np.stack([ds[i][1] for i in range(2)]),
             np.ones((2,), np.float32))
    gpu = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    with deterministic_cudnn():
        kernels = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
        with plain_versions():
            plain = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    cpu = _train_step_once(init, cfg, "cpu", torch.float32, batch)
    f64 = _train_step_once(init, cfg, "cpu", torch.float64, batch)
    differ = _differ(kernels, plain) + ([] if kernels[0] == plain[0] else ["loss"])
    grad_err, stat_err = _rel_errors(gpu[1], cpu[1]), _rel_errors(gpu[2], cpu[2])
    gpu_f64, cpu_f64 = _rel_errors(gpu[1], f64[1]), _rel_errors(cpu[1], f64[1])
    worst_g = max(grad_err, key=grad_err.get)
    worst_s = max(stat_err, key=stat_err.get)
    worst_f64 = max(gpu_f64, key=gpu_f64.get)
    emit("gradcheck", batch=2, image=64, loss_gpu=gpu[0], loss_cpu=cpu[0], loss_f64=f64[0],
         kernels_vs_plain_differ=differ, grad_rtol=GRAD_RTOL, max_grad_err=grad_err[worst_g],
         worst_grad=worst_g, stat_rtol=STAT_RTOL, max_stat_err=stat_err[worst_s],
         worst_stat=worst_s, max_grad_err_gpu_vs_f64=gpu_f64[worst_f64],
         worst_grad_gpu_vs_f64=worst_f64, max_grad_err_cpu_vs_f64=max(cpu_f64.values()),
         grad_err=grad_err, grad_err_gpu_vs_f64=gpu_f64, grad_err_cpu_vs_f64=cpu_f64)
    if differ:
        raise AssertionError(f"the kernels' train step differs from the plain versions' in {differ}")
    if max(grad_err[worst_g], gpu_f64[worst_f64]) > GRAD_RTOL or stat_err[worst_s] > STAT_RTOL:
        raise AssertionError(
            f"the card's train step is off: {worst_g} {grad_err[worst_g]} against the CPU, "
            f"{worst_f64} {gpu_f64[worst_f64]} against f64, {worst_s} {stat_err[worst_s]}"
        )


def phase_router(phase: str = "router", overrides: dict | None = None,
                 kernels: list | None = None) -> dict:
    """``scripts/router.main`` on the synthetic experiment, on the card,
    with the config's parameters set to ``overrides``; ``kernels`` must be
    launched on the way."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(ROUTER_CONFIG) as fh:
            sweep = yaml.safe_load(fh)
        for key, value in (overrides or {}).items():
            sweep["parameters"][key] = {"value": value}
        sweep["parameters"]["output_dir"] = {"value": os.path.join(tmp, "outputs")}
        sweep["parameters"]["checkpoint_dir"] = {"value": os.path.join(tmp, "checkpoints")}
        cfg_path = os.path.join(tmp, "config.yml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(sweep, fh)
        (cfg,) = router.load_config(cfg_path)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the router's progress log
            rc = router.main(["--config", cfg_path, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"router.main returned {rc}")
        paths = [router.results_filename(cfg), router.loss_table_filename(cfg),
                 calibrated_checkpoint_path(cfg["checkpoint_dir"], cfg)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise AssertionError(f"router artifacts missing: {missing}")
        with open(paths[0], "rb") as fh:
            results = pickle.load(fh)
        with open(paths[1], "rb") as fh:
            table = pickle.load(fh)
        names = sorted(os.listdir(cfg["output_dir"])) + sorted(os.listdir(cfg["checkpoint_dir"]))
    if sorted(results) != RESULT_KEYS:
        raise AssertionError(f"results keys {sorted(results)} != the JAX router's {RESULT_KEYS}")
    grid = lambda_grid(cfg)
    if results["lhat"] not in grid:
        raise AssertionError(f"λ̂ {results['lhat']} is not a point of the λ grid")
    if table.ndim != 2 or table.shape[1] != cfg["num_lambdas"] or not np.isfinite(table).all():
        raise AssertionError(f"bad loss table: shape {table.shape}")
    require_launches(phase, counts, kernels or DEFAULT_PATH_KERNELS)
    emit(phase, conv_backend=cfg.get("conv_backend", "auto"), seconds=wall, epochs=cfg["epochs"], images=cfg["num_examples"],
         image=cfg["image_size"], lhat=float(results["lhat"]), risk=float(results["risk"]),
         table_shape=list(table.shape), artifacts=names, launches=counts)
    return counts


def calibrate_and_serve(tag: str, state: UQState, config: dict, calib, serve,
                        kernels: list) -> tuple[UQState, np.ndarray, dict]:
    """``calibrate_model`` on ``calib``, then ``infer.main`` on ``serve``
    from the saved checkpoint and a config file of ``config`` → (the
    calibrated state, the served inputs, the launches). Phases
    ``{tag}calibrate`` and ``{tag}serve``; ``kernels`` must be launched on
    each of the two paths."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, table = calibrate_model(state, calib, config)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_counts = read_counts()
    if table.shape != (len(calib), config["num_lambdas"]) or not np.isfinite(table).all():
        raise AssertionError(f"bad calibration table: shape {table.shape}")
    if not (0.0 <= table.min() and table.max() <= 1.0):
        raise AssertionError("calibration table outside [0, 1]")
    require_launches(f"{tag}calibrate", calib_counts, ["loss_table"] + kernels)
    emit(f"{tag}calibrate", conv_backend=config.get("conv_backend", "auto"), images=len(calib),
         num_lambdas=config["num_lambdas"], lhat=state.lhat, seconds=calib_s,
         launches=calib_counts)

    xs = np.stack([serve[i][0] for i in range(len(serve))])
    ys = np.stack([serve[i][1] for i in range(len(serve))])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_calibrated_checkpoint(state, config, tmp)
        cfg_path = os.path.join(tmp, "config.yml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(config, fh)
        np.save(os.path.join(tmp, "serve.npy"), xs)
        out_dir = os.path.join(tmp, "out")
        reset_counts()
        rc = infer.main([
            "--config", cfg_path, "--checkpoint", ckpt, "--input",
            os.path.join(tmp, "serve.npy"), "--output", out_dir,
            "--batch-size", "32", "--device", "cuda",
        ])
        torch.cuda.synchronize()
        serve_counts = read_counts()
        if rc != 0:
            raise AssertionError(f"infer.main returned {rc}")
        with np.load(os.path.join(out_dir, "serve_intervals.npz")) as z:
            out = {k: z[k] for k in z.files}
        with open(os.path.join(out_dir, "inference_summary.json")) as fh:
            summary = json.load(fh)
    if sorted(out) != ["lam", "lower", "prediction", "upper"]:
        raise AssertionError(f"unexpected npz keys {sorted(out)}")
    lo, pred, hi = out["lower"], out["prediction"], out["upper"]
    for a in (lo, pred, hi):
        if a.shape != xs.shape or not np.isfinite(a).all():
            raise AssertionError(f"bad interval map: shape {a.shape}")
    if not ((lo <= pred).all() and (pred <= hi).all()):
        raise AssertionError("intervals not ordered lower <= prediction <= upper")
    if float(out["lam"]) != state.lhat:
        raise AssertionError(f"served λ {float(out['lam'])} != calibrated λ̂ {state.lhat}")
    require_launches(f"{tag}serve", serve_counts, ["upsample2x"] + kernels)
    emit(f"{tag}serve", conv_backend=config.get("conv_backend", "auto"), images=len(serve),
         imgs_per_sec=summary["imgs_per_sec"], seconds=summary["seconds"], lam=summary["lam"],
         miscoverage=float(((ys < lo) | (ys > hi)).mean()), launches=serve_counts)
    launches = {k: calib_counts[k] + serve_counts[k] for k in KERNELS}
    return state, xs, launches


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _against_default(phase: str, cfg: dict, config: dict, init: dict, batch,
                     default_step: tuple, trained: dict, x: torch.Tensor) -> None:
    """One train step of ``init`` under ``cfg`` against the same step
    under the default config ``config`` (``default_step``), and the eval
    forward of ``trained`` under both: loss within FUSED_LOSS_RTOL, every
    gradient within GRAD_RTOL (a tripwire: see phase_gradcheck), every
    running statistic within FUSED_STAT_RTOL, the eval output within
    FUSED_EVAL_RTOL, relative L2."""
    step = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    grad_err, stat_err = _rel_errors(step[1], default_step[1]), _rel_errors(step[2], default_step[2])
    loss_err = abs(step[0] - default_step[0]) / abs(default_step[0])
    outs = []
    for c in (cfg, config):
        st = add_uncertainty(build_trunk(c), c, device=DEVICE)
        st.model.load_state_dict(trained)
        outs.append(st.forward(x))
        del st
    eval_err = _rel_l2(outs[0], outs[1])
    worst_g = max(grad_err, key=grad_err.get)
    worst_s = max(stat_err, key=stat_err.get)
    emit(phase, conv_backend=cfg["conv_backend"], batch=len(batch[0]), loss=step[0],
         loss_default=default_step[0], loss_rel_err=loss_err, max_grad_err=grad_err[worst_g],
         worst_grad=worst_g, grad_rtol=GRAD_RTOL, max_stat_err=stat_err[worst_s],
         worst_stat=worst_s, stat_rtol=FUSED_STAT_RTOL, eval_rel_err=eval_err,
         eval_rtol=FUSED_EVAL_RTOL, grad_err=grad_err)
    if (loss_err > FUSED_LOSS_RTOL or grad_err[worst_g] > GRAD_RTOL
            or stat_err[worst_s] > FUSED_STAT_RTOL or eval_err > FUSED_EVAL_RTOL):
        raise AssertionError(f"{phase}: {cfg['conv_backend']} is off the default config: loss "
                             f"{loss_err}, {worst_g} {grad_err[worst_g]}, {worst_s} "
                             f"{stat_err[worst_s]}, eval {eval_err}")


def phase_fused(config: dict, calib, serve) -> dict:
    """The model under ``conv_backend: pallas_fused`` at 320x320, batch 32:
    ``make_train_step`` from seed-5 weights (every first gradient finite
    and nonzero; the median of TIMED_STEPS steps after WARMUP_STEPS), one
    step and the eval forward against the default config, and the same
    for ``conv_backend: pallas``; then calibrate and serve the seed-0
    weights of phases 5-6. → launches."""
    cfg = dict(config, conv_backend="pallas_fused")
    bs = cfg["batch_size"]
    ds = synthetic(bs, IMAGE, seed=2)
    batch = (np.stack([ds[i][0] for i in range(bs)]), np.stack([ds[i][1] for i in range(bs)]),
             np.ones((bs,), np.float32))
    state = add_uncertainty(
        build_trunk(cfg), cfg,
        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
    )
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(state.model, head_loss_pe_fn(state.uncertainty_type), cfg, opt)
    tensors = train.put_batch(*batch, torch.device(DEVICE))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(*tensors))]
    first_s = time.perf_counter() - t0
    bad = [n for n, p in state.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
    if bad:
        raise AssertionError(f"fused: after step 1, gradients missing, not finite or zero: {bad}")
    for _ in range(WARMUP_STEPS - 1):
        losses.append(float(step(*tensors)))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    events[0].record()
    for e in events[1:]:
        step(*tensors)
        e.record()
    events[-1].synchronize()
    train_counts = read_counts()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    if not np.isfinite(losses).all():
        raise AssertionError(f"fused train losses not finite: {losses}")
    require_launches("fused_train", train_counts,
                     ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"] + CONV_KERNELS)
    steps = WARMUP_STEPS + TIMED_STEPS
    median_ms = float(np.median(step_ms))
    emit("fused_train", conv_backend="pallas_fused", batch=bs, image=IMAGE, steps=steps,
         median_step_ms=median_ms, imgs_per_sec=1e3 * bs / median_ms, step_ms=step_ms,
         first_step_s=first_s, step_losses=losses,
         launches_per_step={k: v / steps for k, v in train_counts.items()},
         launches=train_counts)
    trained = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del opt, step, tensors

    x = nchw_from_nhwc(batch[0], DEVICE)
    default_step = _train_step_once(init, config, DEVICE, torch.float32, batch)
    _against_default("fused_vs_default", cfg, config, init, batch, default_step, trained, x)
    pallas_cfg = dict(config, conv_backend="pallas")
    reset_counts()
    _against_default("pallas_vs_default", pallas_cfg, config, init, batch, default_step,
                     trained, x)
    pallas_counts = read_counts()
    require_launches("pallas_vs_default", pallas_counts, ["conv3x3"])
    del default_step, x

    # calibrate and serve the default path's seed-0 weights, so that the
    # two configs' times and λ̂ compare (λ̂ moves the host's bound work)
    del state
    state = add_uncertainty(
        build_trunk(cfg), cfg,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    _, _, launches = calibrate_and_serve("fused_", state, cfg, calib, serve,
                                         ["conv3x3", "conv3x3_bn_act"])
    for name in KERNELS:
        launches[name] += train_counts[name] + pallas_counts[name]
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    config = dict(infer.DEFAULTS, **CONFIG)
    grid = lambda_grid(config)
    lam = torch.from_numpy((grid - (grid[1] - grid[0])).astype(np.float32)).cuda()
    measured = {
        "upsample2x": phase_k1(),
        "upsample2x_bwd": phase_k1b(),
        "loss_table": phase_k2(lam),
        "maxpool2x2_bwd": phase_k7(),
        **phase_conv_kernels(),
    }
    measured.update(phase_probes())
    launches = phase_probe_cli()

    # 5-6. calibrate and serve
    t0 = time.perf_counter()
    calib = synthetic(CALIB_N, IMAGE, seed=0)
    serve = synthetic(SERVE_N, IMAGE, seed=1)
    emit("data", images=CALIB_N + SERVE_N, image=IMAGE, seconds=time.perf_counter() - t0)
    state = add_uncertainty(
        build_trunk(config), config,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    state, xs, calib_serve_counts = calibrate_and_serve("", state, config, calib, serve, [])

    # 7. crosscheck: CPU (plain versions) vs the card, fp32, TF32 off
    x2 = nchw_from_nhwc(xs[:2], "cpu")
    on_gpu = state.nested_sets(x2.cuda())
    cpu_state = UQState(model=copy.deepcopy(state.model).cpu(), params=state.params,
                        lhat=state.lhat)
    on_cpu = cpu_state.nested_sets(x2)
    rtol, atol = 1e-4, 1e-5
    errs = []
    for g_t, c_t in zip(on_gpu, on_cpu):
        g_t = g_t.cpu()
        errs.append((g_t - c_t).abs().max().item())
        if not torch.allclose(g_t, c_t, rtol=rtol, atol=atol):
            raise AssertionError(f"CPU and GPU nested sets differ: max abs {errs[-1]}")
    emit("crosscheck", batch=2, rtol=rtol, atol=atol, max_abs_err=errs)
    del state, cpu_state, on_gpu, on_cpu

    # 8-10. train, the router, and the CPU/GPU check of a train step
    train_counts, init, train_cfg = phase_train(config)
    router_counts = phase_router()
    phase_gradcheck(init, train_cfg)
    # 11-13. the fused-conv configs: train, compare, calibrate, serve, router
    fused_counts = phase_fused(config, calib, serve)
    router_fused_counts = phase_router(
        "router_fused", {"conv_backend": "pallas_fused"},
        DEFAULT_PATH_KERNELS + ["conv3x3_bn_act", "conv3x3", "wgrad3x3", "dgrad3x3"])
    for counts in (calib_serve_counts, train_counts, router_counts, fused_counts,
                   router_fused_counts):
        for name, n in counts.items():
            launches[name] += n

    sources = {
        "upsample2x": ("upsample2x.cu", "im2im_uq_tpu/ops/pallas_resize.py:185"),
        "upsample2x_bwd": ("upsample2x_bwd.cu", "im2im_uq_tpu/ops/pallas_resize.py:273"),
        "loss_table": ("loss_table.cu", "im2im_uq_tpu/ops/pallas_kernels.py:89"),
        "maxpool2x2_bwd": ("maxpool2x2_bwd.cu", "im2im_uq_tpu/ops/pallas_pool.py:114"),
        "conv3x3": ("conv3x3.cu", "im2im_uq_tpu/ops/pallas_conv.py:190"),
        "conv3x3_bn_act": ("conv3x3.cu", "im2im_uq_tpu/ops/pallas_conv.py:234"),
        "wgrad3x3": ("wgrad3x3.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:191"),
        "dgrad3x3": ("dgrad3x3.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:315"),
        "moments": ("moments.cu", "benchmarks/bench_moments.py:51"),
        "conv3x3_single": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:51"),
        "conv3x3_db": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:122"),
        "conv3x3_l1": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:196"),
        "conv3x3_c64": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:293"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": f"im2im_uq_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name], **measured[name]}
        for name, (src, replaces) in sources.items()
    ]
    require_launches("main path", launches, KERNELS)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
