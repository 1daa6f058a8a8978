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
4. k2         the loss-table kernel against its plain version at
              (32, 102400) and L=1000, with both times.
5. calibrate  the full-width UNet + quantile head (random weights from a
              seed) calibrated on 128 synthetic 320x320 images, L=1000.
6. serve      save the calibrated checkpoint, run ``scripts/infer.main`` on
              64 more images, check the intervals.
7. crosscheck the same model at batch 2 on the CPU (plain versions) and on
              the card, nested sets compared.

The kernel launch counters are set to 0 just before phase 5 and read after
phase 6, so the ``kernels`` line reports the launches of the main path only.
Any failure raises and the script exits non-zero. The line before the last
is ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.utils.config import DEFAULTS
from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.calibration.rcps import calibrate_model, lambda_grid
from im2im_uq_tpu_torch.models.assembly import (
    UQState,
    add_uncertainty,
    build_trunk,
    nchw_from_nhwc,
)
from im2im_uq_tpu_torch.ops import loss_table, upsample
from im2im_uq_tpu_torch.scripts import infer
from im2im_uq_tpu_torch.training.checkpoint import save_calibrated_checkpoint

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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(t):
    """One bf16 ulp at each value of ``t`` (8 significant bits)."""
    _, exp = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


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
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
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
                tol = bf16_ulp(want)
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
                fields["ms"] = cuda_ms(lambda: upsample.upsample2x(x), 20)
                fields["plain_ms"] = cuda_ms(lambda: upsample.upsample2x_plain(x), 5)
                if dtype == torch.float32:  # the main path's dtype
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    result["ms"] += fields["ms"]
                    result["plain_ms"] += fields["plain_ms"]
            emit("k1", **fields)
    return result


def phase_k2(lam) -> dict:
    """K2 vs plain: equal counts except at exact ties (≤ 1e-5 of the cells)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    n, p = 32, IMAGE * IMAGE
    pred = torch.rand((n, p), generator=g, device="cuda")
    label = pred + 0.3 * torch.randn((n, p), generator=g, device="cuda")
    dl = 0.05 + 0.45 * torch.rand((n, p), generator=g, device="cuda")
    du = 0.05 + 0.45 * torch.rand((n, p), generator=g, device="cuda")
    dl[0, :1000] = 0.0  # zero slopes: missed at every λ where the guard passes
    du[1, :1000] = 0.0
    got = loss_table.loss_table(pred, label, dl, du, lam)
    want = loss_table.loss_table_plain(pred, label, dl, du, lam)
    torch.cuda.synchronize()
    differ = int((got != want).sum().item())
    max_err = (got - want).abs().max().item()
    if differ > 1e-5 * got.numel():
        raise AssertionError(f"K2 disagrees with its plain version in {differ} cells")
    ms = cuda_ms(lambda: loss_table.loss_table(pred, label, dl, du, lam), 10)
    plain_ms = cuda_ms(lambda: loss_table.loss_table_plain(pred, label, dl, du, lam), 2)
    emit("k2", shape=[n, p], num_lambdas=int(lam.shape[0]), cells_differ=differ,
         cells=got.numel(), max_abs_err=max_err, ms=ms, plain_ms=plain_ms)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    config = dict(DEFAULTS, **CONFIG)
    grid = lambda_grid(config)
    lam = torch.from_numpy((grid - (grid[1] - grid[0])).astype(np.float32)).cuda()
    k1 = phase_k1()
    k2 = phase_k2(lam)

    # 5. calibrate
    t0 = time.perf_counter()
    calib = SyntheticDataset(num_examples=CALIB_N, image_size=IMAGE, seed=0)
    serve = SyntheticDataset(num_examples=SERVE_N, image_size=IMAGE, seed=1)
    for ds in (calib, serve):
        for i in range(len(ds)):
            ds[i]  # generate and cache before the timed phases
    data_s = time.perf_counter() - t0
    state = add_uncertainty(
        build_trunk(config), config,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    upsample.upsample2x.launches = 0
    loss_table.loss_table.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, table = calibrate_model(state, calib, config)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    if table.shape != (CALIB_N, config["num_lambdas"]) or not np.isfinite(table).all():
        raise AssertionError(f"bad calibration table: shape {table.shape}")
    if not (0.0 <= table.min() and table.max() <= 1.0):
        raise AssertionError("calibration table outside [0, 1]")
    k1_calib, k2_calib = upsample.upsample2x.launches, loss_table.loss_table.launches
    if k1_calib == 0 or k2_calib == 0:
        raise AssertionError(f"kernels not on the calibration path: K1 {k1_calib}, K2 {k2_calib}")
    emit("calibrate", images=CALIB_N, num_lambdas=config["num_lambdas"], lhat=state.lhat,
         seconds=calib_s, data_seconds=data_s, k1_launches=k1_calib, k2_launches=k2_calib)

    # 6. serve
    xs = np.stack([serve[i][0] for i in range(SERVE_N)])
    ys = np.stack([serve[i][1] for i in range(SERVE_N)])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_calibrated_checkpoint(state, config, tmp)
        cfg_path = os.path.join(tmp, "config.yml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(config, fh)
        np.save(os.path.join(tmp, "serve.npy"), xs)
        out_dir = os.path.join(tmp, "out")
        rc = infer.main([
            "--config", cfg_path, "--checkpoint", ckpt, "--input",
            os.path.join(tmp, "serve.npy"), "--output", out_dir,
            "--batch-size", "32", "--device", "cuda",
        ])
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
    miscoverage = float(((ys < lo) | (ys > hi)).mean())
    k1_serve = upsample.upsample2x.launches - k1_calib
    if k1_serve <= 0:
        raise AssertionError("K1 not on the serving path")
    emit("serve", images=SERVE_N, imgs_per_sec=summary["imgs_per_sec"],
         seconds=summary["seconds"], lam=summary["lam"], miscoverage=miscoverage,
         k1_launches=k1_serve)
    launches = {"upsample2x": upsample.upsample2x.launches,
                "loss_table": loss_table.loss_table.launches}

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

    kernels = [
        {"name": "upsample2x", "route": "cuda",
         "source": "im2im_uq_tpu_torch/csrc/upsample2x.cu",
         "replaces": "im2im_uq_tpu/ops/pallas_resize.py:185",
         "launches": launches["upsample2x"], **k1},
        {"name": "loss_table", "route": "cuda",
         "source": "im2im_uq_tpu_torch/csrc/loss_table.cu",
         "replaces": "im2im_uq_tpu/ops/pallas_kernels.py:89",
         "launches": launches["loss_table"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
