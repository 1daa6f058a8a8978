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
CUDA tensor each launches ``csrc/conv3x3_nhwc.cu``: where :func:`tma_plan`
takes the channels (bfloat16: Cin and Cout multiples of 8 and one slice's
weights resident in a block; float32: multiples of 4) and the tensors are
16-byte aligned (:func:`uses_tma`), the one persistent ``wgmma`` kernel fed
by TMA of that dtype that all four share; otherwise its own instance of the
``cp.async`` / ``mma.sync`` GEMM. The path is chosen before the launch, and
a failed launch raises. No TF32: float32 runs in 3xTF32 on the tensor cores
on both paths. Each wrapper counts its float32 launches apart, on
``wrapper.f32``. On a CPU tensor each runs :func:`conv3x3_nobias_plain`;
any other device raises. The TPU's tiling
gates (H % 8, W % 8 or 16, W even) do not carry over: any H, W ≥ 1. P2 and
P3 take a Cin that fills whole chunks (a multiple of 32 in bfloat16, 16 in
float32), as the probes' own dispatch gives them Cin % 128 == 0; P4 takes any.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional

import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch import _build

__all__ = [
    "TmaPlan",
    "VARIANTS",
    "bf16_tolerance",
    "bf16_ulp",
    "conv3x3_c64",
    "conv3x3_db",
    "conv3x3_l1",
    "conv3x3_nobias_plain",
    "conv3x3_single",
    "cp_async",
    "takes",
    "tma_plan",
    "uses_tma",
]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's chunk of channels (64 bytes a pixel), which P2 and P3 need whole
_CHUNK_BYTES = 64

# The bfloat16 path on wgmma with TMA (csrc/conv3x3_nhwc.cu, namespace tma):
# output tiles of rows x 64 pixels, one block a slice of bn output
# channels with all of that slice's weights resident in shared memory.
_TMA_BNS = (128, 96, 64, 32, 16)  # the instantiated N widths
_TMA_TILE_W = 64
_SMEM_BLOCK = 232448  # bytes of shared memory a block may use on an H100
_SMEM_RESERVED = 1024  # the ring's mbarriers, with room to spare
_TMA_MAX_STAGES = 4
# The float32 path on wgmma with TMA (the same namespace), in 3xTF32: tiles
# of 4 rows x 64 pixels, chunks of one 8-channel box (32 bytes a pixel), the
# chunk's weights as tf32 hi and lo (8 bytes a weight) streamed through the
# ring beside its box
_TMA_F32_BNS = (64, 32)
_TMA_F32_ROWS = 4


@dataclasses.dataclass(frozen=True)
class TmaPlan:
    """The TMA path's sizes for one (Cin, Cout): bn output channels a block
    (``ntn`` slices), ``rows`` output rows a tile, chunks of ``groups`` x 8
    input channels, a ring of ``stages`` chunks, ``smem`` bytes a block. In
    bfloat16 the slice's weights stay in shared memory; in float32 each
    chunk's weights pass through the ring with its activations."""

    bn: int
    rows: int
    groups: int
    stages: int
    ntn: int
    smem: int


def _tma_rows(bn: int) -> int:
    return 8 if bn <= 64 else 4  # the accumulators: at most 128 floats a thread


def _tma_plane(rows: int) -> int:
    """Bytes of one group's haloed box, (rows + 2) x 66 pixels x 16 bytes,
    128-byte aligned."""
    return -(-(rows + 2) * (_TMA_TILE_W + 2) * 16 // 128) * 128


def tma_plan(cin: int, cout: int, dtype: torch.dtype = torch.bfloat16) -> Optional[TmaPlan]:
    """The TMA path's plan for a conv of Cin → Cout in ``dtype``, or None
    where the path does not take it (float32: :func:`_tma_plan_f32`).

    bfloat16: TMA's 16-byte strides need Cin % 8 == 0 and Cout % 8 == 0,
    and one slice's weights (9·Cin'·bn·2 bytes, Cin' padded to whole
    chunks) and a ring of at least two stages must fit a block. For each bn
    the chunk is the largest of 64, 32, 16 channels (not past Cin rounded
    up to 16) that leaves room for three stages, else 16 channels with two
    or more; up to four stages. Among the bn that fit, the least padded N
    (ntn·bn) wins, then the widest bn."""
    if dtype == torch.float32:
        return _tma_plan_f32(cin, cout)
    if dtype != torch.bfloat16 or cin <= 0 or cout <= 0 or cin % 8 or cout % 8:
        return None
    best = None
    for bn in _TMA_BNS:
        rows = _tma_rows(bn)
        plane = _tma_plane(rows)
        fit = None
        for groups in (8, 4, 2):
            if 8 * groups > -(-cin // 16) * 16:
                continue
            kc = 8 * groups
            wbytes = 9 * (-(-cin // kc) * kc) * bn * 2
            room = _SMEM_BLOCK - _SMEM_RESERVED - wbytes
            stages = min(_TMA_MAX_STAGES, room // (groups * plane)) if room > 0 else 0
            if stages >= 3 or (groups == 2 and stages >= 2):
                fit = TmaPlan(bn, rows, groups, stages, -(-cout // bn),
                              wbytes + stages * groups * plane + (2 * stages + 1) * 8)
                break
        if fit is not None and (best is None or fit.ntn * bn < best.ntn * best.bn):
            best = fit
    return best


def _tma_plan_f32(cin: int, cout: int) -> Optional[TmaPlan]:
    """The float32 TMA path's plan: Cin % 4 == 0 and Cout % 4 == 0 (TMA's
    16-byte strides), else None.

    Tiles of 4 rows (two m64 rows a consumer warpgroup, whose sums and
    partials, 2·bn a thread, stay within the 168 registers of a block of
    three warpgroups), chunks of 8 channels, and a ring of up to four
    stages, each a chunk's box ((4 + 2) x 66 pixels x 32 bytes) and its
    weights' hi and lo (9·8·bn·8 bytes): that fits a block at any Cin. bn
    is 64 or 32, whichever pads N least, 64 on a tie."""
    if cin <= 0 or cout <= 0 or cin % 4 or cout % 4:
        return None
    bn = min(_TMA_F32_BNS, key=lambda n: -(-cout // n) * n)
    stage = (_TMA_F32_ROWS + 2) * (_TMA_TILE_W + 2) * 32 + 9 * 8 * bn * 8
    stages = min(_TMA_MAX_STAGES, (_SMEM_BLOCK - _SMEM_RESERVED) // stage)
    return TmaPlan(bn, _TMA_F32_ROWS, 1, stages, -(-cout // bn), stages * stage + 2 * stages * 8)


def uses_tma(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """Whether a CUDA call on these tensors takes the TMA path of its dtype
    (a plan for its channels, 16-byte aligned x and kernel); any other runs
    the cp.async path (``mma.sync`` in bf16, 3xTF32 in f32)."""
    return (x.dtype == kernel.dtype and x.dtype in _KERNEL_DTYPES
            and x.data_ptr() % 16 == 0 and kernel.data_ptr() % 16 == 0
            and tma_plan(x.shape[-1], kernel.shape[-1], x.dtype) is not None)


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
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if uses_tma(x, kernel):
        err = _launch_tma(tma_plan(cin, cout, x.dtype), x, kernel, y, lib, stream)
    else:
        err = _launch_cp_async(variant, x, kernel, y, lib, stream)
    (wrapper.f32 if x.dtype == torch.float32 else wrapper).launches += 1
    _build.check(err, name)
    return y


def _launch_tma(plan: TmaPlan, x: torch.Tensor, kernel: torch.Tensor, y: torch.Tensor, lib,
                stream: int) -> int:
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    dtype = _KERNEL_DTYPES[x.dtype]
    scratch = lib.im2im_conv3x3_nhwc_tma_scratch(cin, cout, plan.bn, plan.groups, dtype)
    wpack = torch.empty(scratch, dtype=torch.uint8, device=x.device)
    return lib.im2im_conv3x3_nhwc_tma(
        x.data_ptr(), kernel.data_ptr(), y.data_ptr(), wpack.data_ptr(), b, h, w, cin, cout,
        plan.bn, plan.groups, plan.stages, dtype, x.device.index, stream,
    )


def _launch_cp_async(variant: int, x: torch.Tensor, kernel: torch.Tensor, y: torch.Tensor, lib,
                     stream: int) -> int:
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    size = x.element_size()
    vec_x = (cin * size) % 16 == 0 and x.data_ptr() % 16 == 0
    vec_w = (cout * size) % 16 == 0 and kernel.data_ptr() % 16 == 0
    return lib.im2im_conv3x3_nhwc(
        x.data_ptr(), kernel.data_ptr(), y.data_ptr(), b, h, w, cin, cout, variant,
        _KERNEL_DTYPES[x.dtype], int(vec_x), int(vec_w), x.device.index, stream,
    )


def cp_async(wrapper, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The ``cp.async`` / ``mma.sync`` kernel of ``wrapper`` (one of
    :data:`VARIANTS`) on CUDA tensors whatever :func:`uses_tma` says,
    counted on no wrapper: the path that a wrapper takes where no plan does,
    run on the TMA path's shapes to compare the two (``chip_smoke.py``'s
    probes phase)."""
    name = f"{wrapper.__name__} (cp.async)"
    _check(name, x, kernel)
    if x.device.type != "cuda" or x.dtype not in _KERNEL_DTYPES or kernel.dtype != x.dtype:
        raise ValueError(f"{name} runs float32 or bfloat16 CUDA tensors, not {x.dtype} on "
                         f"{x.device}")
    x, kernel = x.contiguous(), kernel.contiguous()
    y = torch.empty((*x.shape[:3], kernel.shape[-1]), dtype=x.dtype, device=x.device)
    variant = list(VARIANTS.values()).index(wrapper)
    err = _launch_cp_async(variant, x, kernel, y, _build.library(),
                           torch.cuda.current_stream(x.device).cuda_stream)
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
    """P2: one shared-memory stage, copy then compute (the TMA kernel where
    :func:`uses_tma`)."""
    return _run(conv3x3_single, 0, x, kernel)


def conv3x3_db(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P3: a two-stage cp.async ring (the TMA kernel where :func:`uses_tma`)."""
    return _run(conv3x3_db, 1, x, kernel)


def conv3x3_l1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P4: P3 with a channel tail, for any Cin (the TMA kernel where
    :func:`uses_tma`)."""
    return _run(conv3x3_l1, 2, x, kernel)


def conv3x3_c64(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """P5: Cin = 64, the weights resident in shared memory (the TMA kernel
    where :func:`uses_tma`)."""
    if x.ndim == 4 and x.shape[-1] != 64:
        raise ValueError(f"conv3x3_c64 takes Cin = 64, not {x.shape[-1]}")
    return _run(conv3x3_c64, 3, x, kernel)


# the wrappers by probe, in the order of bench_pallas_conv.py
VARIANTS = {"P2": conv3x3_single, "P3": conv3x3_db, "P4": conv3x3_l1, "P5": conv3x3_c64}
conv3x3_single.launches = 0  # P2 kernel launches since the last reset (bf16)
conv3x3_db.launches = 0  # P3 kernel launches since the last reset (bf16)
conv3x3_l1.launches = 0  # P4 kernel launches since the last reset (bf16)
conv3x3_c64.launches = 0  # P5 kernel launches since the last reset (bf16)
# the launches of the float32 instances, counted apart
conv3x3_single.f32 = types.SimpleNamespace(launches=0)
conv3x3_db.f32 = types.SimpleNamespace(launches=0)
conv3x3_l1.f32 = types.SimpleNamespace(launches=0)
conv3x3_c64.f32 = types.SimpleNamespace(launches=0)
