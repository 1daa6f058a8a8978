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
4. k2         the loss-table kernel against its plain version at
              (32, 102400) and L=1000, with both times.
   k7         the max-pool backward kernel against its plain version and
              against autograd of ``F.max_pool2d``, bit for bit, at the four
              pool inputs of the batch-32 320x320 UNet, odd shapes and tied
              windows, both dtypes, with both times.
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

The kernel launch counters are set to 0 just before each path that a user
runs (calibrate + serve, train, router) and read just after it; the
``kernels`` line reports the sum over those paths. Any failure raises and
the script exits non-zero. The line before the last is ``nvidia-smi``'s
name and power limit; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
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
from im2im_uq_tpu_torch.ops import loss_table, pool, upsample
from im2im_uq_tpu_torch.scripts import infer, router
from im2im_uq_tpu_torch.training import train
from im2im_uq_tpu_torch.training.checkpoint import (
    calibrated_checkpoint_path,
    save_calibrated_checkpoint,
)

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
}


def synthetic(num_examples: int, image_size: int, seed: int):
    """The router's synthetic dataset, every item made before it is timed."""
    ds = router.build_dataset({"dataset": "synthetic", "num_examples": num_examples,
                               "image_size": image_size, "seed": seed})
    for i in range(len(ds)):
        ds[i]
    return ds


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


def phase_k1b() -> dict:
    """K1b vs plain: f32 within 4e-6·max|g| (each dx sums up to 16 taps
    whose weights add up to about 4, so this is a few f32 ulps); bf16
    within one bf16 ulp of the plain result computed in f32 and rounded
    once. Shapes are those of dx (the upsample's input)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
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
                tol = bf16_ulp(want)
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
                fields["ms"] = cuda_ms(lambda: upsample.upsample2x_bwd(g), 20)
                fields["plain_ms"] = cuda_ms(lambda: upsample.upsample2x_bwd_plain(g), 5)
                if dtype == torch.float32:  # the main path's dtype
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    result["ms"] += fields["ms"]
                    result["plain_ms"] += fields["plain_ms"]
            emit("k1b", **fields)
    return result


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
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
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
                fields["ms"] = cuda_ms(lambda: pool.max_pool2x2_bwd(x, g), 20)
                fields["plain_ms"] = cuda_ms(lambda: pool.max_pool2x2_bwd_plain(x, g), 5)
                # torch's own max-pool backward, for scale
                fields["torch_bwd_ms"] = cuda_ms(
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        g, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx), 20)
                if dtype == torch.float32:
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    result["ms"] += fields["ms"]
                    result["plain_ms"] += fields["plain_ms"]
            emit("k7", **fields)
    return result


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


def phase_router() -> dict:
    """``scripts/router.main`` on the synthetic experiment, on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(ROUTER_CONFIG) as fh:
            sweep = yaml.safe_load(fh)
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
    require_launches("router", counts, list(KERNELS))
    emit("router", seconds=wall, epochs=cfg["epochs"], images=cfg["num_examples"],
         image=cfg["image_size"], lhat=float(results["lhat"]), risk=float(results["risk"]),
         table_shape=list(table.shape), artifacts=names, launches=counts)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    config = dict(infer.DEFAULTS, **CONFIG)
    grid = lambda_grid(config)
    lam = torch.from_numpy((grid - (grid[1] - grid[0])).astype(np.float32)).cuda()
    k1 = phase_k1()
    k1b = phase_k1b()
    k2 = phase_k2(lam)
    k7 = phase_k7()

    # 5. calibrate
    t0 = time.perf_counter()
    calib = synthetic(CALIB_N, IMAGE, seed=0)
    serve = synthetic(SERVE_N, IMAGE, seed=1)
    data_s = time.perf_counter() - t0
    state = add_uncertainty(
        build_trunk(config), config,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    reset_counts()
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
    launches = read_counts()

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
    for counts in (train_counts, router_counts):
        for name, n in counts.items():
            launches[name] += n

    kernels = [
        {"name": "upsample2x", "route": "cuda",
         "source": "im2im_uq_tpu_torch/csrc/upsample2x.cu",
         "replaces": "im2im_uq_tpu/ops/pallas_resize.py:185",
         "launches": launches["upsample2x"], **k1},
        {"name": "upsample2x_bwd", "route": "cuda",
         "source": "im2im_uq_tpu_torch/csrc/upsample2x_bwd.cu",
         "replaces": "im2im_uq_tpu/ops/pallas_resize.py:273",
         "launches": launches["upsample2x_bwd"], **k1b},
        {"name": "loss_table", "route": "cuda",
         "source": "im2im_uq_tpu_torch/csrc/loss_table.cu",
         "replaces": "im2im_uq_tpu/ops/pallas_kernels.py:89",
         "launches": launches["loss_table"], **k2},
        {"name": "maxpool2x2_bwd", "route": "cuda",
         "source": "im2im_uq_tpu_torch/csrc/maxpool2x2_bwd.cu",
         "replaces": "im2im_uq_tpu/ops/pallas_pool.py:114",
         "launches": launches["maxpool2x2_bwd"], **k7},
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
