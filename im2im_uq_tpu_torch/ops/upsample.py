"""K1: the 2x align-corners bilinear upsample of every decoder level, and
its backward.

Counterpart of ``im2im_uq_tpu/ops/pallas_resize.py`` (``upsample2x_pallas``
and its custom VJP). :class:`Upsample2x` is the autograd function: its
forward is :func:`upsample2x_fwd` (K1f) and its backward
:func:`upsample2x_bwd` (K1b). On a CUDA tensor each of those launches its
hand-written kernel (``csrc/upsample2x.cu``, ``csrc/upsample2x_bwd.cu``); on
a CPU tensor it runs its plain version in PyTorch ops
(:func:`upsample2x_plain`, :func:`upsample2x_bwd_plain`). Nothing else picks
between the two.

Layout is NCHW: the upsample works on the last two axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.ops.constants import device_constants

__all__ = [
    "Upsample2x",
    "UpsamplePlan",
    "col_transpose_matrix",
    "pallas_upsample_eligible",
    "phase_weights",
    "transpose_weights",
    "upsample2x",
    "upsample2x_axis_plain",
    "upsample2x_bwd",
    "upsample2x_bwd_axis_plain",
    "upsample2x_bwd_plain",
    "upsample2x_fwd",
    "upsample2x_plain",
    "upsample_plan",
    "vector_width",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# columns a thread of the bf16 vector instances: K1f 4 (an 8-byte load a
# row, one 16-byte store an output row, a warp's stores contiguous), K1b 8
# (two 16-byte loads a cotangent row, one 16-byte dx store)
FWD_VECTOR, BWD_VECTOR = 4, 8
# a block's busy threads at least, and at most where whole warps are
# sought (the kernels' launch bound); the rows a thread walks; threads
# across a block's columns at most
BLOCK_THREADS, MAX_THREADS, TILE_ROWS, UNITS_MAX = 128, 512, 4, 256


def phase_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Even/odd-phase lerp fractions of the exact-2x align-corners resize.

    Output 2m = x[m-1] + (x[m]-x[m-1])·fe[m]; output 2m+1 = x[m] +
    (x[m+1]-x[m])·fo[m]. Built in float64 and cast to float32, with
    fe[0] = 1, exactly as ``pallas_resize._phase_weights``.
    """
    if n == 1:
        return np.ones((1,), np.float32), np.zeros((1,), np.float32)
    m = np.arange(n, dtype=np.float64)
    scale = (n - 1) / (2 * n - 1)
    f_even = (2 * m * scale - (m - 1)).astype(np.float32)
    f_even[0] = 1.0
    f_odd = ((2 * m + 1) * scale - m).astype(np.float32)
    return f_even, f_odd


def _device_tables(make, n: int, device: torch.device, dtype: torch.dtype) -> tuple:
    """``make(n)``'s numpy tables as tensors of ``dtype`` on ``device`` (cast
    from f32), kept per size (``ops/constants.py``)."""
    return device_constants(
        (make.__name__, n, device, dtype), (n,),
        lambda: (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype).to(device)
                 for a in make(n)))


def upsample2x_axis_plain(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact-2x align-corners upsample along ``dim``: two shifted lerps and
    an interleave (``im2im_uq_tpu/ops/resize._upsample2x_axis``)."""
    n = x.shape[dim]
    xm1 = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    xp1 = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    shape = [1] * x.ndim
    shape[dim] = n
    fe, fo = (t.reshape(shape) for t in _device_tables(phase_weights, n, x.device, x.dtype))
    even = xm1 + (x - xm1) * fe
    odd = x + (xp1 - x) * fo
    out_shape = list(x.shape)
    out_shape[dim] = 2 * n
    return torch.stack([even, odd], dim + 1).reshape(out_shape)


def _pick_row_tile(h: int) -> int | None:
    """Largest row tile that divides H with at least two tiles
    (``pallas_resize._pick_row_tile``)."""
    for th in (16, 10, 8, 5, 4):
        if h % th == 0 and h >= th + 2:
            return th
    return None


def _lane_pad(c: int) -> int:
    """Channels the TPU kernel runs at: C padded to the 128 lanes
    (``pallas_resize._lane_pad``)."""
    return -(-c // 128) * 128


def pallas_upsample_eligible(shape, dtype: torch.dtype) -> bool:
    """Whether the NHWC ``shape`` (B, H, W, C) of ``dtype`` takes the TPU
    kernel in the JAX package (``pallas_resize.pallas_upsample_eligible``):
    the decoder routes the upsample to K1 exactly where this holds
    (``ops/resize.upsample2x_align_corners``)."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if dtype not in (torch.bfloat16, torch.float32):
        return False
    if w % 8 != 0 or c % 8 != 0 or c < 32:
        return False
    if _lane_pad(c) > 2 * c:
        return False
    return _pick_row_tile(h) is not None


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for the kernels' dtypes (f32, bf16); f64 stays f64."""
    return torch.promote_types(dtype, torch.float32)


@functools.lru_cache(maxsize=64)
def col_transpose_matrix(w: int) -> np.ndarray:
    """(2W, W) f32 matrix M of the W axis, output column j = Σ_v M[j, v]·x[v]
    (``pallas_resize._col_transpose_matrix``): column 2v reads v − 1 and v,
    column 2v + 1 reads v and v + 1, and the taps past the edges are
    absent. ``1 − fe``, ``1 − fo`` are taken in f32."""
    ge, go = phase_weights(w)
    mat = np.zeros((2 * w, w), np.float32)
    for v in range(w):
        mat[2 * v, v] += ge[v]
        mat[2 * v + 1, v] += 1.0 - go[v]
        if v + 1 < w:
            mat[2 * v + 2, v] += 1.0 - ge[v + 1]
        if v >= 1:
            mat[2 * v - 1, v] += go[v - 1]
    return mat


def _col_matrix(w: int) -> tuple[np.ndarray]:
    return (col_transpose_matrix(w),)


def _bf16_weights(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _upsample2x_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's bf16 function (``_upsample2x_fwd_raw``): the H-axis
    lerps in bf16, each operation rounded, with bf16 phase weights and zero
    rows past the edges; then the W axis as an f32 product with the bf16
    entries of :func:`col_transpose_matrix`, rounded once."""
    h, w = x.shape[-2:]
    fe, fo = (f[:, None] for f in _device_tables(phase_weights, h, x.device, torch.bfloat16))
    zero = torch.zeros_like(x.narrow(-2, 0, 1))
    xm1 = torch.cat([zero, x.narrow(-2, 0, h - 1)], -2)
    xp1 = torch.cat([x.narrow(-2, 1, h - 1), zero], -2)
    even = xm1 + (x - xm1) * fe
    odd = x + (xp1 - x) * fo
    rows = torch.stack([even, odd], -2).flatten(-3, -2)  # (…, 2H, W)
    (m,) = _device_tables(_col_matrix, w, x.device, torch.bfloat16)
    return torch.einsum("...v,jv->...j", rows.float(), m.float()).to(torch.bfloat16)


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """K1's plain version. bf16: the TPU kernel's rounding
    (:func:`_upsample2x_bf16_plain`). Otherwise the lerp along H, then W, in
    f32 (f64 for an f64 input), one rounding at the end."""
    if x.dtype == torch.bfloat16:
        return _upsample2x_bf16_plain(x)
    y = x.to(_compute_dtype(x.dtype))
    y = upsample2x_axis_plain(y, x.ndim - 2)
    y = upsample2x_axis_plain(y, x.ndim - 1)
    return y.to(x.dtype)


def transpose_weights(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tap weights (a0, a1, a2, a3) of the upsample's transpose along an axis
    of n inputs: dx[m] = a1·g[2m] + a3·g[2m+2] + a2·g[2m+1] + a0·g[2m−1]
    (``pallas_resize._upsample2x_bwd_raw``, :281-287), f32."""
    fe, fo = phase_weights(n)
    one = np.float32(1.0)
    a0 = np.concatenate([[0.0], fo[:-1]]).astype(np.float32)
    a3 = np.concatenate([one - fe[1:], [0.0]]).astype(np.float32)
    return a0, fe, one - fo, a3


def upsample2x_bwd_axis_plain(g: torch.Tensor, dim: int) -> torch.Tensor:
    """Transpose of :func:`upsample2x_axis_plain` along ``dim`` (2n → n).

    The taps outside the axis are clamped onto real elements, which their
    weight of exactly 0 cancels, as in the forward.
    """
    n = g.shape[dim] // 2
    pairs = g.unflatten(dim, (n, 2))
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)  # g[2m], g[2m+1]
    even_next = torch.cat([even.narrow(dim, 1, n - 1), even.narrow(dim, n - 1, 1)], dim)
    odd_prev = torch.cat([odd.narrow(dim, 0, 1), odd.narrow(dim, 0, n - 1)], dim)
    shape = [1] * even.ndim
    shape[dim] = n
    a0, a1, a2, a3 = (t.reshape(shape)
                      for t in _device_tables(transpose_weights, n, g.device, g.dtype))
    return a1 * even + a3 * even_next + a2 * odd + a0 * odd_prev


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """K1b's plain version: (…, 2H, 2W) cotangent → (…, H, W), the W axis
    first and then H, in f32 (f64 for an f64 cotangent) with one rounding at
    the end."""
    d = g.to(_compute_dtype(g.dtype))
    d = upsample2x_bwd_axis_plain(d, g.ndim - 1)
    d = upsample2x_bwd_axis_plain(d, g.ndim - 2)
    return d.to(g.dtype)


@functools.lru_cache(maxsize=64)
def _weight_table(n: int, device: torch.device) -> torch.Tensor:
    """(2n,) f32 table [fe | fo] on ``device``, kept per size."""
    fe, fo = phase_weights(n)
    return torch.from_numpy(np.concatenate([fe, fo])).to(device)


@functools.lru_cache(maxsize=64)
def _bf16_tables(h: int, w: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's f32 tables on ``device``, kept per size: (2h,)
    [fe | fo] rounded to bf16, and (4w,) the W taps of
    :func:`col_transpose_matrix` per input column v rounded to bf16, [M[2v,
    v − 1] | M[2v, v] | M[2v + 1, v] | M[2v + 1, v + 1]], 0 past the edges."""
    m = np.pad(col_transpose_matrix(w), ((0, 0), (1, 1)))  # column v of M is v + 1
    v = np.arange(w)
    taps = np.concatenate([m[2 * v, v], m[2 * v, v + 1], m[2 * v + 1, v + 1],
                           m[2 * v + 1, v + 2]])
    wh = _bf16_weights(np.concatenate(phase_weights(h))).float()
    return wh.to(device), _bf16_weights(taps).float().to(device)


@functools.lru_cache(maxsize=64)
def _transpose_table(n: int, device: torch.device) -> torch.Tensor:
    """(4n,) f32 table [a0 | a1 | a2 | a3] on ``device``, kept per size."""
    return torch.from_numpy(np.concatenate(transpose_weights(n))).to(device)


@dataclasses.dataclass(frozen=True)
class UpsamplePlan:
    """How the bf16 kernels (``csrc/upsample2x.cu``, ``csrc/upsample2x_bwd.cu``)
    cut planes of (h, w) input (K1f) or dx (K1b) elements.

    A thread owns ``vec`` adjacent columns of one plane and walks down a
    tile of ``rows`` rows of them; ``tiles`` tiles cover h, the last one
    ragged where ``rows`` does not divide h. A block is ``units`` threads
    across the columns by ``groups`` planes, all at one tile: block x
    index = plane group · tiles + tile, y index = the column tile (of
    ``col_tiles``). ``csrc/upsample2x_tile.cuh`` computes the same plan
    and the entry point ``im2im_upsample2x_plan`` returns it."""

    vec: int
    units: int
    col_tiles: int
    rows: int
    tiles: int
    groups: int


@functools.lru_cache(maxsize=256)
def upsample_plan(h: int, w: int, vec: int) -> UpsamplePlan:
    """The plan of the bf16 K1f/K1b at a plane of (h, w) input (dx)
    elements and ``vec`` columns a thread: tiles of ``TILE_ROWS`` rows (the
    last one ragged), a block of at least ``BLOCK_THREADS`` threads, whole
    warps where that stays within ``MAX_THREADS``."""
    if vec not in (1, FWD_VECTOR, BWD_VECTOR) or w % vec:
        raise ValueError(f"vector width {vec} does not fit W = {w}")
    units_total = w // vec
    units = min(units_total, UNITS_MAX)
    groups = -(-BLOCK_THREADS // units)
    step = 32 // math.gcd(units, 32)
    aligned = -(-groups // step) * step
    if units * aligned <= MAX_THREADS:
        groups = aligned
    rows = min(h, TILE_ROWS)
    return UpsamplePlan(vec=vec, units=units, col_tiles=-(-units_total // units), rows=rows,
                        tiles=-(-h // rows), groups=groups)


def vector_width(vec: int, w: int, *data_ptrs: int) -> int:
    """Columns a thread of a bf16 kernel whose vector instance takes
    ``vec``: ``vec`` where W % vec == 0 and every pointer is 16-byte
    aligned, else 1 (the same kernel body, one column a thread)."""
    if w % vec == 0 and all(p % 16 == 0 for p in data_ptrs):
        return vec
    return 1


def _bf16_kind(vec: int, w: int, *tensors: torch.Tensor) -> int:
    """The C entry points' kind argument for a bf16 launch: 1 the kernel's
    vector instance, 2 one column a thread (0 is float32)."""
    return 1 if vector_width(vec, w, *(t.data_ptr() for t in tensors)) > 1 else 2


def _check(t: torch.Tensor, kernel: str) -> None:
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, got {t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{kernel} kernel takes NCHW input, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel} kernel takes a contiguous NCHW tensor")


def _launch(x: torch.Tensor) -> torch.Tensor:
    _check(x, "upsample2x")
    b, c, h, w = x.shape
    y = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    if x.dtype == torch.bfloat16:
        wh, ww = _bf16_tables(h, w, x.device)
        kind = _bf16_kind(FWD_VECTOR, w, x, y)
    else:
        wh, ww = _weight_table(h, x.device), _weight_table(w, x.device)
        kind = 0
    err = _build.library().im2im_upsample2x(
        x.data_ptr(), y.data_ptr(), wh.data_ptr(), ww.data_ptr(),
        b * c, h, w, kind, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    upsample2x.launches += 1
    _build.check(err, "upsample2x")
    return y


def _launch_bwd(g: torch.Tensor) -> torch.Tensor:
    _check(g, "upsample2x_bwd")
    b, c, h2, w2 = g.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"upsample2x_bwd takes an even-sized cotangent, got {tuple(g.shape)}")
    h, w = h2 // 2, w2 // 2
    dx = torch.empty((b, c, h, w), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    ah, aw = _transpose_table(h, g.device), _transpose_table(w, g.device)
    kind = _bf16_kind(BWD_VECTOR, w, g, dx) if g.dtype == torch.bfloat16 else 0
    err = _build.library().im2im_upsample2x_bwd(
        g.data_ptr(), dx.data_ptr(), ah.data_ptr(), aw.data_ptr(),
        b * c, h, w, kind, g.device.index,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    upsample2x_bwd.launches += 1
    _build.check(err, "upsample2x_bwd")
    return dx


def upsample2x_fwd(x: torch.Tensor) -> torch.Tensor:
    """K1f's wrapper, without autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _launch(x)
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    raise RuntimeError(f"upsample2x runs on cuda or cpu tensors, not {x.device}")


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """K1b's wrapper: (B, C, 2H, 2W) cotangent → (B, C, H, W). The kernel on
    a CUDA tensor, the plain version on a CPU tensor; any other device raises."""
    if g.device.type == "cuda":
        return _launch_bwd(g)
    if g.device.type == "cpu":
        return upsample2x_bwd_plain(g)
    raise RuntimeError(f"upsample2x_bwd runs on cuda or cpu tensors, not {g.device}")


class Upsample2x(torch.autograd.Function):
    """The upsample as an autograd function: K1f forward, K1b backward.

    The op is linear, so nothing is saved for the backward. The cotangent
    is made contiguous first: after ``Up``'s centre pad it arrives as a
    slice of the padded tensor's gradient.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_fwd(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return upsample2x_bwd(g.contiguous())


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2H, 2W), bilinear with align_corners=True,
    differentiable through :class:`Upsample2x` on every device."""
    return Upsample2x.apply(x)


upsample2x.launches = 0  # K1f kernel launches since the last reset
upsample2x_bwd.launches = 0  # K1b kernel launches since the last reset
