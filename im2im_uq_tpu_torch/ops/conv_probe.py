"""P2-P5: the 3×3 same-padding convolution without bias, NHWC / HWIO.

Counterpart of the Pallas probes of ``benchmarks/bench_pallas_conv.py``,
one wrapper each:

- :func:`conv3x3_single` (P2, ``conv3x3_pallas``): single-buffered;
- :func:`conv3x3_db` (P3, ``conv3x3_pallas_db``): double-buffered;
- :func:`conv3x3_l1` (P4, ``conv3x3_pallas_l1``): any Cin (a channel tail);
- :func:`conv3x3_c64` (P5, ``conv3x3_pallas_c64``): Cin = 64 only.

Each takes x (B, H, W, Cin) float32 or bfloat16 and a kernel (3, 3, Cin,
Cout) of the same dtype and returns (B, H, W, Cout) in x's dtype: the nine
shifted products accumulated in float32, rounded once to x's dtype. On a
CUDA tensor each launches its instance of ``csrc/conv3x3_nhwc.cu`` (no
TF32: float32 runs in 3xTF32 on the tensor cores); on a CPU tensor each runs
:func:`conv3x3_nobias_plain`; any other device raises. The TPU's tiling
gates (H % 8, W % 8 or 16, W even) do not carry over: any H, W ≥ 1. P2 and
P3 take a Cin that fills whole chunks (a multiple of 32 in bfloat16, 16 in
float32), as the probes' own dispatch gives them Cin % 128 == 0; P4 takes any.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch import _build

__all__ = [
    "VARIANTS",
    "bf16_tolerance",
    "bf16_ulp",
    "conv3x3_c64",
    "conv3x3_db",
    "conv3x3_l1",
    "conv3x3_nobias_plain",
    "conv3x3_single",
    "takes",
]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's chunk of channels (64 bytes a pixel), which P2 and P3 need whole
_CHUNK_BYTES = 64


def conv3x3_nobias_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The plain version: 9 shifted (B·H·W, Cin) @ (Cin, Cout) products over
    the zero-padded input, accumulated in float32 (bfloat16 operands widened,
    so every product is exact), then cast to x's dtype
    (``bench_pallas_conv.py:38-46``)."""
    b, h, w, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    k = kernel.float()
    acc = None
    for dh in range(3):
        for dw in range(3):
            xs = xp[:, dh : dh + h, dw : dw + w, :].reshape(b * h * w, cin)
            t = xs @ k[dh, dw]
            acc = t if acc is None else acc + t
    return acc.reshape(b, h, w, kernel.shape[-1]).to(x.dtype)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of ``t`` (8 significant bits), float32."""
    _, exp = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


def bf16_tolerance(x: torch.Tensor, kernel: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The bar of a bfloat16 result against the plain version's ``want``,
    per output: one bfloat16 ulp of ``want`` (the two round different float32
    sums, so a sum near a rounding boundary may land on either side), plus
    the worst-case difference of two float32 sums of the same K = 9·Cin
    products in different orders, 2·K·2^-24·Σ|x||w|, which matters only
    where the sum cancels to near zero and its ulp is smaller than that."""
    mass = conv3x3_nobias_plain(x.float().abs(), kernel.float().abs())
    return bf16_ulp(want) + 2.0 * 9 * x.shape[-1] * 2.0**-24 * mass


def takes(probe: str, cin: int, dtype: torch.dtype) -> bool:
    """Whether the wrapper of ``probe`` ("P2".."P5") takes this Cin."""
    if probe == "P5":
        return cin == 64
    if probe in ("P2", "P3"):
        return cin % (_CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()) == 0
    return True


def _check(name: str, x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.ndim != 4 or kernel.ndim != 4 or tuple(kernel.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} is not a 3x3 HWIO kernel over "
                         f"the channels of the NHWC input {tuple(x.shape)}")


def _launch(wrapper, variant: int, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    name = wrapper.__name__
    if x.dtype not in _KERNEL_DTYPES or kernel.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes x and kernel both float32 or both bfloat16, got "
                        f"{x.dtype} and {kernel.dtype}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    if kernel.device != x.device:
        raise ValueError(f"{name} kernel takes x and kernel on one device")
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    size = x.element_size()
    vec_x = (cin * size) % 16 == 0 and x.data_ptr() % 16 == 0
    vec_w = (cout * size) % 16 == 0 and kernel.data_ptr() % 16 == 0
    err = _build.library().im2im_conv3x3_nhwc(
        x.data_ptr(), kernel.data_ptr(), y.data_ptr(), b, h, w, cin, cout, variant,
        _KERNEL_DTYPES[x.dtype], int(vec_x), int(vec_w), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    wrapper.launches += 1
    _build.check(err, name)
    return y


def _run(wrapper, variant: int, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    name = wrapper.__name__
    _check(name, x, kernel)
    if variant in (0, 1) and not takes("P2", x.shape[-1], x.dtype):
        raise ValueError(f"{name} takes Cin a multiple of {_CHUNK_BYTES // x.element_size()} "
                         f"in {x.dtype}, not {x.shape[-1]}: conv3x3_l1 takes any Cin")
    if x.device.type == "cuda":
        return _launch(wrapper, variant, x, kernel)
    if x.device.type == "cpu":
        return conv3x3_nobias_plain(x, kernel)
    raise RuntimeError(f"{name} runs on cuda or cpu tensors, not {x.device}")


def conv3x3_single(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P2: one shared-memory stage, copy then compute."""
    return _run(conv3x3_single, 0, x, kernel)


def conv3x3_db(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P3: a two-stage cp.async ring."""
    return _run(conv3x3_db, 1, x, kernel)


def conv3x3_l1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P4: P3 with a channel tail, for any Cin."""
    return _run(conv3x3_l1, 2, x, kernel)


def conv3x3_c64(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P5: Cin = 64, the weights resident in shared memory."""
    if x.ndim == 4 and x.shape[-1] != 64:
        raise ValueError(f"conv3x3_c64 takes Cin = 64, not {x.shape[-1]}")
    return _run(conv3x3_c64, 3, x, kernel)


# the wrappers by probe, in the order of bench_pallas_conv.py
VARIANTS = {"P2": conv3x3_single, "P3": conv3x3_db, "P4": conv3x3_l1, "P5": conv3x3_c64}
conv3x3_single.launches = 0  # P2 kernel launches since the last reset
conv3x3_db.launches = 0  # P3 kernel launches since the last reset
conv3x3_l1.launches = 0  # P4 kernel launches since the last reset
conv3x3_c64.launches = 0  # P5 kernel launches since the last reset
