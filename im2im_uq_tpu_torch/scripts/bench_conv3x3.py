"""Microbench of P2-P5, the bias-free 3×3 conv in NHWC: the kernels
against ``F.conv2d``.

    python -m im2im_uq_tpu_torch.scripts.bench_conv3x3 [batch] [size] [cin]
        [cout] [--check] [--device cuda]

Counterpart of ``benchmarks/bench_pallas_conv.py``. x (batch, size, size,
cin) and a kernel (3, 3, cin, cout) from ``RandomState(0)`` (defaults 32,
320, 64, 64), bfloat16. The variants follow Cin as the probe picks them:
Cin a multiple of 128 runs P2 and P3, Cin = 64 runs P5, any other Cin P4.
The library call ``F.conv2d`` always runs, on the channels_last view
``x.permute(0, 3, 1, 2)`` (the same memory, no copy). Each line gives ms per
call and effective GB/s (x, y and the kernel moved once); each kernel's
output is held to :func:`conv3x3_nobias_plain` within
:func:`ops.conv_probe.bf16_tolerance` (one bfloat16 ulp, plus the float32
sums' order where they cancel to near zero).

``--check`` runs P2-P5 instead in float32 at (2, 32, 32, cin) against
``conv3x3_nobias_plain`` on the same device, at rtol = atol = 2e-5 (the
probe's own bar), each variant that takes this Cin. TF32 is off. On the card
times come from CUDA events; ``--device`` defaults to ``cuda`` and raises
without one; ``--device cpu`` runs the plain versions on the host clock.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch.ops import conv_probe
from im2im_uq_tpu_torch.scripts.router import resolve_device
from im2im_uq_tpu_torch.utils.timing import time_ms

__all__ = ["main", "variants_for"]

CHECK_TOL = 2e-5  # bench_pallas_conv.py:399
ITERS = 10


def variants_for(cin: int) -> list[str]:
    """The probes the CLI times at this Cin (bench_pallas_conv.py:408-414)."""
    if cin % 128 == 0:
        return ["P2", "P3"]
    return ["P5"] if cin == 64 else ["P4"]


def _inputs(batch, size, cin, cout, dtype, device):
    rng = np.random.RandomState(0)
    x = rng.randn(batch, size, size, cin).astype(np.float32)
    k = (0.1 * rng.randn(3, 3, cin, cout)).astype(np.float32)
    return (torch.from_numpy(x).to(device=device, dtype=dtype),
            torch.from_numpy(k).to(device=device, dtype=dtype))


def _check(cin: int, cout: int, device: torch.device) -> None:
    x, k = _inputs(2, 32, cin, cout, torch.float32, device)
    want = conv_probe.conv3x3_nobias_plain(x, k)
    for name, fn in conv_probe.VARIANTS.items():
        if not conv_probe.takes(name, cin, x.dtype):
            print(f"{name} {fn.__name__}: skipped, it does not take Cin = {cin}")
            continue
        got = fn(x, k)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=CHECK_TOL, atol=CHECK_TOL)
        print(f"parity OK ({name} {fn.__name__}) {tuple(got.shape)}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, help="[batch] [size] [cin] [cout]")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    batch, size, cin, cout = (list(args.sizes) + [32, 320, 64, 64][len(args.sizes):])[:4]
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.check:
        _check(cin, cout, device)
        return 0

    x, k = _inputs(batch, size, cin, cout, torch.bfloat16, device)
    w_lib = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_lib = x.permute(0, 3, 1, 2)  # channels_last NCHW view of the same memory
    want = conv_probe.conv3x3_nobias_plain(x, k)
    tol = conv_probe.bf16_tolerance(x, k, want)
    gb = (x.numel() + want.numel() + k.numel()) * x.element_size() / 1e9
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"--- bfloat16 x {tuple(x.shape)} kernel {tuple(k.shape)} on {where} ---")
    runs = [("library F.conv2d", None, lambda: F.conv2d(x_lib, w_lib, padding=1))]
    runs += [(f"{name} {conv_probe.VARIANTS[name].__name__}", name,
              lambda fn=conv_probe.VARIANTS[name]: fn(x, k)) for name in variants_for(cin)]
    for label, name, fn in runs:
        if name is not None:
            err = (fn().float() - want.float()).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"{label} is off its plain version by {err.max().item()}")
        ms = time_ms(fn, ITERS, device)
        print(f"{label:28s} {ms:8.3f} ms/call   ({gb:.3f} GB moved once: "
              f"{gb / (ms / 1e3):7.1f} GB/s effective)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
