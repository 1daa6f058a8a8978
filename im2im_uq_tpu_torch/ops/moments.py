"""P1: per-channel moments of an NHWC tensor (BatchNorm's statistics).

Counterpart of ``benchmarks/bench_moments.py`` (``pallas_moments``, the
Pallas probe of per-channel Σx and Σx², and ``xla_moments``). For x of shape
(..., C), n = the product of the leading sizes:

    mean = Σx / n,  var = Σx² / n − mean²

over the n rows, in float32 (a bfloat16 x is widened first): the probe's
single-pass formula, not Welford's. :func:`moments` launches the kernel of
``csrc/moments.cu`` on a CUDA tensor and runs :func:`moments_plain` on a CPU
tensor; any other device raises.
"""

from __future__ import annotations

import torch

from im2im_uq_tpu_torch import _build

__all__ = ["finish", "moment_sums", "moment_sums_plain", "moments", "moments_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moment_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, C) float32: Σx and Σx² over every axis but the last."""
    x32 = x.float().reshape(-1, x.shape[-1])
    return torch.stack([x32.sum(0), (x32 * x32).sum(0)])


def finish(sums: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) from the (2, C) sums over n rows, as the probe finishes
    them; divided by a tensor (made on the device, no copy from the host),
    so that each quotient is an IEEE division."""
    nt = sums.new_full((), float(n))
    mean = sums[0] / nt
    return mean, sums[1] / nt - mean * mean


def moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P1's plain version: (mean, var), each (C,) float32."""
    return finish(moment_sums_plain(x), x.numel() // max(x.shape[-1], 1))


def _launch(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"moments kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim < 1 or not x.is_contiguous():
        raise ValueError("moments kernel takes a contiguous tensor of rows of channels")
    if x.numel() == 0:
        raise ValueError(f"moments of an empty tensor {tuple(x.shape)}")
    c = x.shape[-1]
    n = x.numel() // c
    lib = _build.library()
    blocks = lib.im2im_moments_blocks(n, x.device.index)
    part = torch.empty((blocks, 2, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    vec = (c * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    err = lib.im2im_moments(
        x.data_ptr(), part.data_ptr(), sums.data_ptr(), n, c, blocks, _KERNEL_DTYPES[x.dtype],
        int(vec), x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    moments.launches += 1
    _build.check(err, "moments")
    return sums


def moment_sums(x: torch.Tensor) -> torch.Tensor:
    """(2, C) float32 Σx and Σx²: the kernel on a CUDA tensor, the plain
    version on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _launch(x)
    if x.device.type == "cpu":
        return moment_sums_plain(x)
    raise RuntimeError(f"moments runs on cuda or cpu tensors, not {x.device}")


def moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var), each (C,) float32, of the rows of an NHWC ``x``."""
    return finish(moment_sums(x), x.numel() // max(x.shape[-1], 1))


moments.launches = 0  # kernel launches since the last reset
