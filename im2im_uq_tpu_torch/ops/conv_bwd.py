"""K5 and K6: the backward of the fused 3×3 conv (``ops/conv.conv3x3_bn_act``).

Counterpart of ``im2im_uq_tpu/ops/pallas_conv_bwd.py``:

- :func:`wgrad3x3` (K5, ``wgrad3x3_pallas_raw``): dW and db of a 3×3
  same-padding conv over ``relu(x·scale + shift)`` (with the prologue) or
  ``x``, the activation recomputed from the raw input inside the kernel;
- :func:`dgrad3x3` (K6, ``dgrad3x3_pallas_raw``): dx through the flipped
  kernel, times the ReLU mask ``x·scale + shift > 0`` and ``scale`` with the
  prologue, and the reductions (Σ dam·x, Σ dam) that are the gradients of
  ``scale`` and ``shift``.

Layout NCHW; weights and dW in ``nn.Conv2d``'s (Cout, Cin, 3, 3). On a CUDA
tensor each wrapper launches its kernel (``csrc/wgrad3x3_tma.cu`` or
``csrc/wgrad3x3.cu``, ``csrc/dgrad3x3_tma.cu`` or ``csrc/dgrad3x3.cu``); on
a CPU tensor it runs its plain version; any other device raises. K5 in
float32 runs ``wgmma`` in 3xTF32 fed by TMA (``csrc/wgrad3x3_tma.cu``)
wherever :func:`wgrad_f32_plan` takes the shape and the tensors are 16-byte
aligned (:func:`wgrad_f32_uses_tma`); the stem (Cin = 1) and the other
shapes run the ``mma.sync`` / ``cp.async`` kernel of ``csrc/wgrad3x3.cu``,
which :func:`wgrad3x3_mma_sync` also runs on any float32 CUDA shape, for
comparisons. K6 in float32 likewise runs its own ``wgmma`` kernel in
3xTF32 fed by TMA (``csrc/dgrad3x3_tma.cu``) wherever :func:`dgrad_f32_plan`
takes the shape (:func:`dgrad_f32_uses_tma`), and ``csrc/dgrad3x3.cu``'s
``cp.async``-fed kernel elsewhere, also callable as
:func:`dgrad3x3_cp_async`. The route is chosen before the launch; a failed
launch raises. The float32 launches on the TMA paths count on
``wgrad3x3.tma`` and ``dgrad3x3.tma`` besides ``wgrad3x3.launches`` and
``dgrad3x3.launches``. x, g and the weight are float32 or bfloat16 (the TPU kernels'
dtypes, ``pallas_conv_bwd.py:51-63``); scale, shift, dW, db and the
reductions float32; dx in x's dtype. In bf16 the products are exact bf16 ×
bf16 products summed in float32: K5's activation is rounded to bf16 before
them (``pallas_conv_bwd.py:145-155``), K6's dx once at the end
(``:296-303``). A bf16 instance counts its launches apart, on
``wgrad3x3.bf16`` and ``dgrad3x3.bf16``. The JAX package takes padded
inputs and pads W to 8 for Mosaic; the port takes the unpadded tensors.

In bf16 both kernels read one cotangent, as the JAX package's read its one
padded cotangent (``pallas_conv.py:371-376, 424-427``):
:func:`cotangent_nhwc` writes it once, NHWC with the channels padded to a
multiple of 8 (:func:`padded_channels`), the stats' terms added when given;
:func:`wgrad3x3_nhwc` (K5, which writes its activation NHWC first with
:func:`activation_nhwc` and sums db as it reads g) and :func:`dgrad3x3_nhwc`
(K6) read it through TMA into ``wgmma`` (``csrc/conv3x3_bf16.cu``),
planned by :func:`wgrad_plan` and :func:`dgrad_plan`. :func:`wgrad3x3` and
:func:`dgrad3x3` on bf16 CUDA tensors run the cotangent pass on their ``g``
and then the same kernels. The passes count their launches on
``cotangent_nhwc`` and ``activation_nhwc``.

This module also owns what K3-K6 share in bf16: the NHWC passes, the tile
plans (:class:`TilePlan`, :func:`conv_plan` beside :func:`dgrad_plan`) and
:func:`sm_count`. The bf16 K3/K4 (``ops/conv.py``) run on K6's kernel body
over :func:`activation_nhwc`'s copy of x, planned by :func:`conv_plan`.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Optional

import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch import _build

__all__ = [
    "DgradF32Plan", "TilePlan", "WgradPlan", "activation_nhwc", "activation_plain", "conv_plan",
    "cotangent_nhwc", "cotangent_plain", "dgrad3x3", "dgrad3x3_cp_async", "dgrad3x3_nhwc",
    "dgrad3x3_nhwc_plain", "dgrad3x3_plain", "dgrad_f32_plan", "dgrad_f32_uses_tma",
    "dgrad_plan", "from_nhwc", "padded_channels",
    "stem_slices", "to_nhwc", "WgradF32Plan", "wgrad3x3", "wgrad3x3_mma_sync", "wgrad3x3_nhwc",
    "wgrad3x3_nhwc_plain", "wgrad3x3_plain", "wgrad_f32_plan", "wgrad_f32_uses_tma", "wgrad_plan",
]

# a block's shared memory and the SMs of an H100 (the plans' defaults)
SMEM_BYTES, SMS = 232448, 132
# the most k-steps of 16 pixels a K5 block sums in the tensor core's
# accumulator (its truncating adds: about 2e-8 relative a k-step)
K5_DEPTH = 2048

# the dtype codes of the C entry points
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K5's float32 path on wgmma with TMA (csrc/wgrad3x3_tma.cu): blocks of 64
# output channels x 16 row groups of (tap, 16 input channels), reading at
# most 3 groups of 16 channels of the activation; a ring of 5 to 8 stages
# (a chunk reads the activation rows of the two events before it and a
# consumer drains its partial every stages - 4 chunks, so at its wait the
# stages - 2 events before it may be unreleased: 5 keeps the producer
# ahead); the time of a chunk of one column (µs, at about 70% of the
# 3xTF32 rate on an H100) and a warm-up event's share of a chunk's, for
# the split-K plan
K5F_BN, K5F_ROW_GROUPS, K5F_SLOTS = 64, 16, 3
K5F_MIN_STAGES, K5F_MAX_STAGES = 5, 8
K5F_US_PER_COLUMN, K5F_WARM_UP = 0.04, 0.25
# K6's float32 path on wgmma with TMA (csrc/dgrad3x3_tma.cu): blocks of 64
# input channels x tiles of at most 256 pixels, chunks of 8 output channels
# x 9 taps (their weights' tf32 hi and lo: 36,864 bytes a stage beside the
# cotangent's box: at most 85 KB, so two always fit), the consumer warps'
# reduction slots, a ring of up to 4 stages
K6F_BN, K6F_KC, K6F_TILE_PX = 64, 8, 256
K6F_WCHUNK = 18 * K6F_BN * K6F_KC * 4
K6F_RED_BYTES = 8 * K6F_BN * 2 * 4
K6F_MAX_STAGES = 4


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 if it is narrower (bf16 → f32, exact); f32 and f64
    as they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def prologue_activation(x, scale, shift, prologue: bool) -> torch.Tensor:
    if not prologue:
        return x
    return torch.relu(x * _per_channel(scale) + _per_channel(shift))


def wgrad3x3_plain(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: per tap, Σ over (b, y, x) of g · the shifted
    activation, as nine matrix products → (dW (Cout, Cin, 3, 3), db (Cout,)).

    A bf16 input is computed in float32 from its widened operands: the
    activation relu(f32(x)·scale + shift), rounded to bf16, 0 in the frame;
    dW the f32 sum of the exact products, db = Σ f32(g), both float32."""
    h, w = x.shape[-2:]
    a = widened(prologue_activation(widened(x), scale, shift, prologue).to(x.dtype))
    g = widened(g)
    ap = F.pad(a, (1, 1, 1, 1))
    taps = [torch.einsum("bohw,bchw->oc", g, ap[:, :, dh : dh + h, dw : dw + w])
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps, -1).unflatten(-1, (3, 3)), g.sum((0, 2, 3))


def dgrad3x3_plain(
    g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version → (dx (B, Cin, H, W) in x's dtype, red (2, Cin)).

    da[b, c, y, x] = Σ g[b, co, y+1−dh, x+1−dw]·W[co, c, dh, dw] as nine
    matrix products over the padded cotangent; with the prologue dam = da
    where x·scale + shift > 0 (else 0), dx = dam·scale and red = (Σ dam·x,
    Σ dam) per channel; without it dx = da and red = 0. A bf16 input is
    computed in float32 from its widened operands (da, the mask, dam and red
    in f32) and dx is rounded to bf16 once.
    """
    h, w = g.shape[-2:]
    gp = F.pad(widened(g), (1, 1, 1, 1))
    weight = widened(weight)
    da = None
    for dh in range(3):
        for dw in range(3):
            t = torch.einsum("oc,bohw->bchw", weight[:, :, dh, dw],
                             gp[:, :, 2 - dh : 2 - dh + h, 2 - dw : 2 - dw + w])
            da = t if da is None else da + t
    if not prologue:
        return da.to(x.dtype), da.new_zeros((2, x.shape[1]))
    xw = widened(x)
    mask = (xw * _per_channel(scale) + _per_channel(shift) > 0).to(da.dtype)
    dam = da * mask
    red = torch.stack([(dam * xw).sum((0, 2, 3)), dam.sum((0, 2, 3))])
    return (dam * _per_channel(scale)).to(x.dtype), red


def padded_channels(c: int) -> int:
    """C rounded up to a multiple of 8: a pixel of 8 bf16 channels is the
    16 bytes that TMA and ``wgmma`` take as a row."""
    return -(-c // 8) * 8


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H, W, padded_channels(C)), contiguous, the padding
    0: the layout that the bf16 K5 and K6 read."""
    b, c, h, w = t.shape
    out = t.new_zeros((b, h, w, padded_channels(c)))
    out[..., :c] = t.permute(0, 2, 3, 1)
    return out


def from_nhwc(t: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of :func:`to_nhwc`: the first ``c`` channels, NCHW."""
    return t[..., :c].permute(0, 3, 1, 2).contiguous()


def activation_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                     shift: Optional[torch.Tensor], prologue: bool) -> torch.Tensor:
    """The activation pass's plain version → NHWC: with the prologue
    relu(f32(x)·scale + shift) rounded to x's dtype (the product and the sum
    each rounded, as the TPU kernel's bf16 operand, ``pallas_conv.py:153-160``),
    else x; then the layout change (:func:`to_nhwc`)."""
    a = prologue_activation(widened(x), scale, shift, prologue).to(x.dtype)
    return to_nhwc(a)


def cotangent_plain(gy: torch.Tensor, y: Optional[torch.Tensor],
                    gst: Optional[torch.Tensor]) -> torch.Tensor:
    """The cotangent pass's plain version → g NHWC.

    With the stats' cotangent ``gst`` (B, 2, C): g = (f32(gy) + gs) + 2·f32(y)·gq
    rounded to gy's dtype, as ``pallas_conv.py:371-376``; without it g = gy.
    Then the layout change (:func:`to_nhwc`)."""
    g = gy
    if gst is not None:
        g = (widened(gy) + gst[:, 0, :, None, None]
             + 2.0 * widened(y) * gst[:, 1, :, None, None]).to(gy.dtype)
    return to_nhwc(g)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """K6, or K3/K4, in bf16 at one shape (the kernel body ``k6::run`` of
    ``csrc/conv3x3_bf16.cu``): N slices of ``bn`` channels, output tiles of
    ``th`` x ``tw`` pixels, a ring of ``stages`` chunks of 16 K channels,
    ``blocks`` persistent blocks (``per_slice`` of each slice); bytes of a
    group's box (``plane``), a stage, the output tile of the TMA epilogue
    (K6: x, then dx; K3/K4: y; 0 where the epilogue stores itself) and the
    block's shared memory."""

    bn: int
    th: int
    tw: int
    stages: int
    ntn: int
    per_slice: int
    blocks: int
    tiles: int
    chunks: int
    plane: int
    stage_bytes: int
    xs_bytes: int
    smem: int

    @property
    def wpack_elems(self) -> int:
        return self.ntn * self.chunks * 9 * 16 * self.bn


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _tile_plan(b: int, kdim: int, ndim: int, h: int, w: int, sms: int,
               sum_buffers: int) -> TilePlan:
    """N = ``ndim`` channels in slices of 64 (N ≤ 64) or 128; a tile's M rows
    are 512 or 256 flattened box positions (two warpgroups of 4 or 2 m64
    instances). Of the column splits whose haloed box is at most 256 wide,
    the tile (th rows x tw columns, th the most rows whose positions fit M)
    that computes the fewest M rows in all (its width a multiple of 8 where
    W is). Where W and the tile's width are multiples of 8, the output
    passes through shared memory by TMA (the TMA epilogue, ``xs_bytes``).
    Chunks of 16 of the ``kdim`` K channels; as many stages as fit beside
    ``sum_buffers`` [warp][N][2] float buffers of sums, up to 4; one
    persistent block per SM, the slices side by side."""
    bn = 64 if ndim <= 64 else 128
    mt = 64 * (4 if bn == 64 else 2) * 2
    best = None
    for nx in range(1, w + 1):
        tw = -(-w // nx)
        if tw + 2 > 256 or tw > mt or -(-w // tw) != nx or (w % 8 == 0 and tw % 8):
            continue
        th = min(h, (mt - tw) // (tw + 2) + 1, 254)
        tiles = b * -(-h // th) * nx
        if best is None or tiles < best[0]:
            best = (tiles, th, tw)
    tiles, th, tw = best
    hc = tw + 2
    plane = _round_up(max((th + 2) * hc, mt + 2 * hc + 2) * 16, 128)
    stage = _round_up(2 * plane + 9 * 16 * bn * 2, 128)
    xs = _round_up(th * tw * bn * 2, 128) if w % 8 == 0 and tw % 8 == 0 else 0
    fixed = sum_buffers * 8 * bn * 2 * 4 + xs + 16
    stages = min(4, (SMEM_BYTES - fixed) // (stage + 16))
    ntn = -(-ndim // bn)
    per_slice = max(1, min(tiles, sms // ntn))
    return TilePlan(bn=bn, th=th, tw=tw, stages=stages, ntn=ntn, per_slice=per_slice,
                    blocks=per_slice * ntn, tiles=tiles, chunks=-(-padded_channels(kdim) // 16),
                    plane=plane, stage_bytes=stage, xs_bytes=xs,
                    smem=stages * stage + 16 * stages + fixed)


@functools.lru_cache(maxsize=256)
def dgrad_plan(b: int, cin: int, cout: int, h: int, w: int, sms: int = SMS) -> TilePlan:
    """The plan of K6 in bf16 (``csrc/conv3x3_bf16.cu``, ``k6::dgrad_kernel``):
    N = Cin, K = Cout (the cotangent's channels), one buffer of each warp's
    running reductions (:func:`_tile_plan`)."""
    return _tile_plan(b, cout, cin, h, w, sms, 1)


@functools.lru_cache(maxsize=256)
def conv_plan(b: int, cin: int, cout: int, h: int, w: int, sms: int = SMS) -> TilePlan:
    """The plan of K3/K4 in bf16 (``csrc/conv3x3_bf16.cu``,
    ``k6::conv3x3_fwd_wgmma_kernel``): N = Cout, K = Cin (the NHWC copy's
    channels), two buffers of a tile's stats (:func:`_tile_plan`)."""
    return _tile_plan(b, cin, cout, h, w, sms, 2)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """K5 in bf16 at one shape: tiles of ``th`` x ``tw`` pixels, a ring of
    ``stages``, ``slices`` runs of ``per_slice`` tiles, each run by
    ``blocks_per_slice`` blocks (64 output x 64 input channels each);
    bytes of g's box and the activation's (64 channels a 128-byte row, the
    128-byte swizzle), a stage and the block's shared memory."""

    th: int
    tw: int
    stages: int
    tiles: int
    per_slice: int
    slices: int
    blocks_per_slice: int
    gbytes: int
    abytes: int
    stage_bytes: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.slices * self.blocks_per_slice


def _waves_filled(blocks: int, sms: int) -> float:
    return blocks / (-(-blocks // sms) * sms)


@functools.lru_cache(maxsize=256)
def wgrad_plan(b: int, cin: int, cout: int, h: int, w: int, sms: int = SMS) -> WgradPlan:
    """The plan of K5 in bf16 (``csrc/conv3x3_bf16.cu``, namespace k5).

    Tiles of th x tw pixels, tw a multiple of 8 up to 248 and th·tw a
    multiple of 16 up to 256 (k-steps of 16 pixels): the tile that computes
    the fewest pixels in all, counting 64 more a tile for its pipeline and
    an eighth of its haloed box for the activation's loads. As many stages
    as fit, up to 4. Split K: at least the slices that keep a block's sum
    in the tensor core within K5_DEPTH k-steps; of those, up to 4 waves of
    blocks, the number that fills the SMs' last wave best, the fewest on a
    tie."""
    best = None
    for tw in range(8, min(_round_up(w, 8), 248) + 1, 8):
        nx = -(-w // tw)
        for th in range(1, 256 // tw + 1):
            if (th * tw) % 16:
                continue
            tiles = b * -(-h // th) * nx
            cost = tiles * (th * tw + 64) + tiles * (th + 2) * (tw + 2) / 8
            if best is None or cost < best[0]:
                best = (cost, th, tw, tiles)
    _, th, tw, tiles = best
    gbytes = _round_up(th * tw * 128, 1024)
    abytes = _round_up((th + 2) * (tw + 2) * 128, 1024)
    stage = gbytes + abytes
    stages = min(4, (SMEM_BYTES - 64) // (stage + 16))
    per = -(-cout // 64) * -(-padded_channels(cin) // 64)
    # a block's products accumulate in the tensor core over at most
    # K5_DEPTH k-steps, which bounds their rounding
    fewest = -(-tiles * (th * tw // 16) // K5_DEPTH)
    pick = None
    for s in range(min(tiles, fewest), min(tiles, max(fewest, 4 * sms // per)) + 1):
        per_slice = -(-tiles // s)
        slices = -(-tiles // per_slice)
        key = (_waves_filled(slices * per, sms), -slices)
        if pick is None or key > pick[0]:
            pick = (key, per_slice, slices)
    _, per_slice, slices = pick
    return WgradPlan(th=th, tw=tw, stages=stages, tiles=tiles, per_slice=per_slice,
                     slices=slices, blocks_per_slice=per, gbytes=gbytes, abytes=abytes,
                     stage_bytes=stage, smem=stages * stage + 16 * stages)


@dataclasses.dataclass(frozen=True)
class WgradF32Plan:
    """K5 in float32 on ``wgmma`` with TMA at one shape (``csrc/wgrad3x3_tma.cu``):
    chunks of one row of ``tw`` columns (``chunks`` in all, strips of tw
    columns walked row by row), a ring of ``stages`` of ``stage_bytes``
    (the chunk's g as tf32 hi and lo, one row of 3 x 16 channels of the
    activation, HC = tw + 12 columns from the strip's x0 - 4: a TMA box
    starts on 16 bytes), ``smem`` bytes a block; ``mtiles`` x
    ``ntiles`` tiles of 256 (tap, channel) rows x 64 output channels, each
    split into ``slices`` runs of ``per_slice`` chunks."""

    tw: int
    stages: int
    stage_bytes: int
    smem: int
    mtiles: int
    ntiles: int
    chunks: int
    per_slice: int
    slices: int

    @property
    def hc(self) -> int:
        return self.tw + 12

    @property
    def blocks(self) -> int:
        return self.slices * self.mtiles * self.ntiles


def k5f_stage_bytes(tw: int) -> int:
    """Bytes of a stage of K5's float32 ring: g's hi and lo (tw / 4 boxes of
    64 channels x 4 pixels each) and a row of 3 x 16 channels x (tw + 12)
    columns of the activation, 1024-byte aligned."""
    return _round_up(2 * (tw // 4) * K5F_BN * 16 + K5F_SLOTS * 64 * (tw + 12), 1024)


def k5f_smem(tw: int, stages: int) -> int:
    """A block's shared memory: the ring and three mbarriers a stage."""
    return stages * (k5f_stage_bytes(tw) + 24)


def _k5f_stages(tw: int) -> int:
    return min(K5F_MAX_STAGES, SMEM_BYTES // (k5f_stage_bytes(tw) + 24))


@functools.lru_cache(maxsize=256)
def wgrad_f32_plan(b: int, cin: int, cout: int, h: int, w: int,
                   sms: int = SMS) -> Optional[WgradF32Plan]:
    """The plan of K5 in float32 on ``wgmma`` with TMA, or None where that
    path does not take the shape: Cin a multiple of 16 (the rows' channel
    groups; so never the stem) and W of 4 (TMA's 16-byte row strides).

    The chunk's width tw: a multiple of 8 whose ring holds 5 stages (up to
    56), the one that computes the fewest columns over a row's strips
    (the padding past W included), each strip's 12 frame columns counted
    a quarter (they are loaded, not computed); the widest on a tie. Split K:
    the number of slices whose estimated time is least, counting whole
    waves of blocks (one a SM), a slice's chunks and warm-ups, and the
    partial sums written and read back; the fewest on a tie."""
    if min(b, cout, h, w) <= 0 or cin < 16 or cin % 16 or w % 4:
        return None
    widths = [tw for tw in range(8, min(_round_up(w, 8), 128) + 1, 8)
              if _k5f_stages(tw) >= K5F_MIN_STAGES]
    tw = min(widths, key=lambda t: (-(-w // t) * (t + 3), -t))
    stages = _k5f_stages(tw)
    mtiles = -(-9 * (cin // 16) // K5F_ROW_GROUPS)
    ntiles = -(-cout // K5F_BN)
    tiles = mtiles * ntiles
    chunks = b * -(-w // tw) * h
    partial_us = cout * (9 * cin + 1) * 4 * 3 / 3.35e6  # a slice's: written, read, summed
    best = None
    for want in range(1, min(chunks, max(16, 16 * sms // tiles)) + 1):
        per_slice = -(-chunks // want)
        slices = -(-chunks // per_slice)
        events = per_slice + 2 * K5F_WARM_UP * (-(-per_slice // h) + 1)
        cost = (-(-tiles * slices // sms) * events * tw * K5F_US_PER_COLUMN
                + slices * partial_us)
        if best is None or cost < best[0]:
            best = (cost, per_slice, slices)
    _, per_slice, slices = best
    return WgradF32Plan(tw=tw, stages=stages, stage_bytes=k5f_stage_bytes(tw),
                        smem=k5f_smem(tw, stages), mtiles=mtiles, ntiles=ntiles, chunks=chunks,
                        per_slice=per_slice, slices=slices)


def wgrad_f32_uses_tma(x: torch.Tensor, g: torch.Tensor) -> bool:
    """Whether a float32 K5 call on these tensors takes the TMA path: a plan
    for its shape (:func:`wgrad_f32_plan`) and x and g 16-byte aligned;
    any other runs the ``mma.sync`` kernel."""
    b, cin, h, w = x.shape
    return (x.dtype == g.dtype == torch.float32 and x.data_ptr() % 16 == 0
            and g.data_ptr() % 16 == 0 and wgrad_f32_plan(b, cin, g.shape[1], h, w) is not None)


@dataclasses.dataclass(frozen=True)
class DgradF32Plan:
    """K6 in float32 on ``wgmma`` with TMA at one shape
    (``csrc/dgrad3x3_tma.cu``): output tiles of ``th`` x ``tw`` pixels
    (``tiles`` in all), the cotangent's box of 8 channels x ``rows`` x ``hc``
    columns from (x0 - 4, y0 - 1) (``box_bytes``), a ring of ``stages`` of
    ``stage_bytes`` (the box, then a chunk's packed weights), ``smem`` bytes
    a block; ``ntn`` slices of 64 input channels, each walked by
    ``per_slice`` persistent blocks."""

    th: int
    tw: int
    hc: int
    rows: int
    stages: int
    box_bytes: int
    stage_bytes: int
    smem: int
    ntn: int
    tiles: int
    per_slice: int

    @property
    def blocks(self) -> int:
        return self.per_slice * self.ntn


def k6f_box(th: int, tw: int) -> Optional[tuple[int, int]]:
    """(hc, rows) of K6's float32 box for tiles of th x tw: hc = tw + 8 or
    tw + 12 columns (a multiple of 4: 16-byte TMA rows from x0 - 4, past x0 +
    tw; at most 256, TMA's box) and rows >= th + 2, whose channel plane
    rows·hc is an odd multiple of 8 floats (a lane's 4 channels 8 banks
    apart); tw + 8 where tw is not a multiple of 8 (the 8 pixels of a load
    then cross a tile row, and stay 8 apart in the banks only if the row's
    jump is 8). The smallest plane, or None where no box fits."""
    best = None
    for hc in (tw + 8, tw + 12):
        if (tw % 8 and hc != tw + 8) or hc > 256:
            continue
        for rows in range(th + 2, th + 6):
            if rows * hc % 16 == 8 and (best is None or rows * hc < best[0]):
                best = (rows * hc, hc, rows)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=256)
def dgrad_f32_plan(b: int, cin: int, cout: int, h: int, w: int,
                   sms: int = SMS) -> Optional[DgradF32Plan]:
    """The plan of K6 in float32 on ``wgmma`` with TMA, or None where that
    path does not take the shape: Cin a multiple of 64 (the blocks' N
    slices) and W of 4 (TMA's 16-byte row strides).

    The tile: tw a multiple of 4 up to W (and 248) whose box fits
    (:func:`k6f_box`), th = the rows of 256 pixels (at most H); the one with
    the fewest tiles, the smallest box on a tie. As many stages as fit, up
    to 4; one persistent block per SM, the slices side by side."""
    if min(b, cout, h, w) <= 0 or cin <= 0 or cin % K6F_BN or w % 4:
        return None
    best = None
    for tw in range(4, min(_round_up(w, 4), 248) + 1, 4):
        th = min(h, K6F_TILE_PX // tw)
        box = k6f_box(th, tw)
        tiles = b * -(-h // th) * -(-w // tw)
        if box is not None and (best is None or (tiles, box[0] * box[1]) < best[0]):
            best = ((tiles, box[0] * box[1]), th, tw) + box
    (tiles, _), th, tw, hc, rows = best
    box = K6F_KC * rows * hc * 4
    stage = _round_up(box, 128) + K6F_WCHUNK  # the box, then a chunk's packed weights
    stages = min(K6F_MAX_STAGES, (SMEM_BYTES - K6F_RED_BYTES) // (stage + 16))
    ntn = cin // K6F_BN
    return DgradF32Plan(th=th, tw=tw, hc=hc, rows=rows, stages=stages, box_bytes=box,
                        stage_bytes=stage, smem=stages * (stage + 16) + K6F_RED_BYTES, ntn=ntn,
                        tiles=tiles, per_slice=max(1, min(tiles, sms // ntn)))


def dgrad_f32_uses_tma(g: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether a float32 K6 call on these tensors takes the TMA path: a plan
    for its shape (:func:`dgrad_f32_plan`) and g and x 16-byte aligned; any
    other runs ``csrc/dgrad3x3.cu``'s kernel."""
    b, cin, h, w = x.shape
    return (x.dtype == g.dtype == torch.float32 and x.data_ptr() % 16 == 0
            and g.data_ptr() % 16 == 0 and dgrad_f32_plan(b, cin, g.shape[1], h, w) is not None)


@functools.lru_cache(maxsize=256)
def stem_slices(npx: int, sms: int = SMS) -> tuple[int, int]:
    """(pixels a block, blocks) of K5's stem: four blocks per SM."""
    slices = max(1, min(npx, 4 * sms))
    per_slice = -(-npx // slices)
    return per_slice, -(-npx // per_slice)


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, which the plans fill."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_tensors(kernel: str, device: torch.device, dtype: torch.dtype = torch.float32,
                  **tensors) -> None:
    """Raise unless every tensor given is of ``dtype``, contiguous and on
    ``device``."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{kernel} kernel takes {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes contiguous tensors, not {name}")
        if t.device != device:
            raise ValueError(f"{kernel} kernel takes tensors on one device, {name} is on {t.device}")


def check_kernel_dtype(kernel: str, t: torch.Tensor) -> None:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, got {t.dtype}")


def check_prologue(kernel: str, scale, shift, cin: int) -> None:
    if scale is None or shift is None or scale.shape != (cin,) or shift.shape != (cin,):
        raise ValueError(f"{kernel} with the prologue takes scale and shift of shape ({cin},)")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_cotangent(gy, y, gst):
    kernel = "cotangent_nhwc"
    if gy.dtype != torch.bfloat16 or gy.ndim != 4:
        raise TypeError(f"{kernel} kernel takes a bf16 NCHW cotangent, got {gy.dtype} "
                        f"{tuple(gy.shape)}")
    check_tensors(kernel, gy.device, torch.bfloat16, gy=gy, y=y)
    check_tensors(kernel, gy.device, gst=gst)
    b, c, h, w = gy.shape
    if gst is not None and (y is None or y.shape != gy.shape or gst.shape != (b, 2, c)):
        raise ValueError(f"{kernel}: y {None if y is None else tuple(y.shape)} and gst "
                         f"{tuple(gst.shape)} do not match the cotangent {tuple(gy.shape)}")
    out = torch.empty((b, h, w, padded_channels(c)), dtype=torch.bfloat16, device=gy.device)
    if gy.numel() == 0:
        return out.zero_()
    err = _build.library().im2im_nhwc_pass(
        gy.data_ptr(), y.data_ptr() if gst is not None else None,
        gst.data_ptr() if gst is not None else None, None, None, out.data_ptr(),
        b, c, padded_channels(c), h, w, 1, gy.device.index, stream_of(gy),
    )
    cotangent_nhwc.launches += 1
    _build.check(err, kernel)
    return out


def _launch_activation(x, scale, shift, prologue: bool):
    kernel = "activation_nhwc"
    if x.dtype != torch.bfloat16 or x.ndim != 4:
        raise TypeError(f"{kernel} kernel takes a bf16 NCHW input, got {x.dtype} "
                        f"{tuple(x.shape)}")
    check_tensors(kernel, x.device, torch.bfloat16, x=x)
    check_tensors(kernel, x.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    b, c, h, w = x.shape
    if prologue:
        check_prologue(kernel, scale, shift, c)
    out = torch.empty((b, h, w, padded_channels(c)), dtype=torch.bfloat16, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    sc, sh = (scale.data_ptr(), shift.data_ptr()) if prologue else (None, None)
    err = _build.library().im2im_nhwc_pass(x.data_ptr(), None, None, sc, sh, out.data_ptr(), b, c,
                                           padded_channels(c), h, w, 0, x.device.index,
                                           stream_of(x))
    activation_nhwc.launches += 1
    _build.check(err, kernel)
    return out


def wgrad3x3_nhwc_plain(x, gp, cout: int, scale, shift, prologue: bool):
    """:func:`wgrad3x3_nhwc`'s plain version: :func:`wgrad3x3_plain` of the
    NCHW cotangent."""
    return wgrad3x3_plain(x, from_nhwc(gp, cout), scale, shift, prologue)


def dgrad3x3_nhwc_plain(gp, x, weight, scale, shift, prologue: bool):
    """:func:`dgrad3x3_nhwc`'s plain version: :func:`dgrad3x3_plain` of the
    NCHW cotangent."""
    return dgrad3x3_plain(from_nhwc(gp, weight.shape[0]), x, weight, scale, shift, prologue)


def _check_nhwc(kernel: str, gp: torch.Tensor, x: torch.Tensor, cout: int) -> None:
    check_tensors(kernel, x.device, torch.bfloat16, x=x, g=gp)
    if (gp.ndim != 4 or x.ndim != 4 or gp.shape[0] != x.shape[0] or gp.shape[1:3] != x.shape[2:]
            or gp.shape[3] != padded_channels(cout)):
        raise ValueError(f"{kernel}: NHWC cotangent {tuple(gp.shape)} of {cout} channels does "
                         f"not match the NCHW input {tuple(x.shape)}")


def _launch_wgrad_nhwc(x, gp, cout: int, scale, shift, prologue: bool):
    kernel = "wgrad3x3"
    _check_nhwc(kernel, gp, x, cout)
    check_tensors(kernel, x.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    b, cin, h, w = x.shape
    if prologue:
        check_prologue(kernel, scale, shift, cin)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty((cout,), dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_(), db.zero_()
    lib, dev, stream = _build.library(), x.device.index, stream_of(x)
    sc, sh = (scale.data_ptr(), shift.data_ptr()) if prologue else (None, None)
    if cin == 1:
        per_slice, slices = stem_slices(b * h * w, sm_count(dev))
        part = torch.empty((slices * cout * 10,), dtype=torch.float32, device=x.device)
        err = lib.im2im_wgrad3x3_stem(x.data_ptr(), gp.data_ptr(), sc, sh, part.data_ptr(),
                                      dw.data_ptr(), db.data_ptr(), b, cout, gp.shape[3], h, w,
                                      int(prologue), per_slice, slices, dev, stream)
    else:
        plan = wgrad_plan(b, cin, cout, h, w, sm_count(dev))
        act = _launch_activation(x, scale, shift, prologue)
        part = torch.empty((plan.slices * cout * (cin * 9 + 4),), dtype=torch.float32,
                           device=x.device)
        err = lib.im2im_wgrad3x3_wgmma(act.data_ptr(), gp.data_ptr(), part.data_ptr(),
                                       dw.data_ptr(), db.data_ptr(), b, cin, act.shape[3], cout,
                                       gp.shape[3], h, w, plan.th, plan.tw, plan.stages,
                                       plan.per_slice, plan.slices, dev, stream)
    wgrad3x3.bf16.launches += 1
    _build.check(err, kernel)
    return dw, db


def _launch_dgrad_nhwc(gp, x, weight, scale, shift, prologue: bool):
    kernel = "dgrad3x3"
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    _check_nhwc(kernel, gp, x, cout)
    check_tensors(kernel, x.device, torch.bfloat16, weight=weight)
    check_tensors(kernel, x.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"dgrad3x3: weight {tuple(weight.shape)} is not ({cout}, {cin}, 3, 3)")
    if prologue:
        check_prologue(kernel, scale, shift, cin)
    dx = torch.empty_like(x)
    red = torch.zeros((2, cin), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, red
    if cout == 0:
        return dx.zero_(), red
    dev = x.device.index
    plan = dgrad_plan(b, cin, cout, h, w, sm_count(dev))
    wpack = torch.empty((plan.wpack_elems,), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((plan.per_slice * 2 * cin,), dtype=torch.float32, device=x.device)
    err = _build.library().im2im_dgrad3x3_wgmma(
        gp.data_ptr(), weight.data_ptr(), x.data_ptr(),
        scale.data_ptr() if prologue else None, shift.data_ptr() if prologue else None,
        dx.data_ptr(), wpack.data_ptr(), part.data_ptr(), red.data_ptr(), b, cin, cout,
        gp.shape[3], h, w, int(prologue), plan.bn, plan.th, plan.tw, plan.stages, plan.blocks,
        dev, stream_of(x),
    )
    dgrad3x3.bf16.launches += 1
    _build.check(err, kernel)
    return dx, red


def _check_wgrad(kernel: str, x, g, scale, shift, prologue: bool) -> None:
    check_tensors(kernel, x.device, x=x, g=g)
    check_tensors(kernel, x.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    if x.ndim != 4 or g.ndim != 4 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"{kernel}: input {tuple(x.shape)} and cotangent {tuple(g.shape)} "
                         "are not one NCHW conv's")
    if prologue:
        check_prologue(kernel, scale, shift, x.shape[1])


def _wgrad_outputs(x, g):
    cout = g.shape[1]
    return (torch.empty((cout, x.shape[1], 3, 3), dtype=torch.float32, device=x.device),
            torch.empty((cout,), dtype=torch.float32, device=x.device))


def _wgrad_mma_sync(x, g, scale, shift, prologue: bool, dw, db) -> int:
    b, cin, h, w = x.shape
    cout = g.shape[1]
    lib = _build.library()
    scratch = torch.empty((lib.im2im_wgrad3x3_scratch(b, cin, cout, h, w),),
                          dtype=torch.float32, device=x.device)
    return lib.im2im_wgrad3x3(
        x.data_ptr(), g.data_ptr(), scale.data_ptr() if prologue else None,
        shift.data_ptr() if prologue else None, scratch.data_ptr(), dw.data_ptr(), db.data_ptr(),
        b, cin, cout, h, w, int(prologue), x.device.index, stream_of(x),
    )


def _wgrad_tma(plan: WgradF32Plan, x, g, scale, shift, prologue: bool, dw, db) -> int:
    b, cin, h, w = x.shape
    cout = g.shape[1]
    part = torch.empty((plan.slices * (cout * cin * 9 + cout),), dtype=torch.float32,
                       device=x.device)
    return _build.library().im2im_wgrad3x3_tma(
        x.data_ptr(), g.data_ptr(), scale.data_ptr() if prologue else None,
        shift.data_ptr() if prologue else None, part.data_ptr(), dw.data_ptr(), db.data_ptr(),
        b, cin, cout, h, w, int(prologue), plan.tw, plan.stages, plan.per_slice, plan.slices,
        x.device.index, stream_of(x),
    )


def _launch_wgrad(x, g, scale, shift, prologue: bool):
    _check_wgrad("wgrad3x3", x, g, scale, shift, prologue)
    dw, db = _wgrad_outputs(x, g)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_(), db.zero_()
    if wgrad_f32_uses_tma(x, g):
        b, cin, h, w = x.shape
        plan = wgrad_f32_plan(b, cin, g.shape[1], h, w, sm_count(x.device.index))
        err = _wgrad_tma(plan, x, g, scale, shift, prologue, dw, db)
        wgrad3x3.tma.launches += 1
    else:
        err = _wgrad_mma_sync(x, g, scale, shift, prologue, dw, db)
    wgrad3x3.launches += 1
    _build.check(err, "wgrad3x3")
    return dw, db


def wgrad3x3_mma_sync(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's ``mma.sync`` / ``cp.async`` kernel (``csrc/wgrad3x3.cu``) on
    float32 CUDA tensors whatever :func:`wgrad_f32_uses_tma` says, counted
    on no wrapper: the path of the stem and of the shapes off the plan, run
    on the TMA path's shapes to compare the two (``chip_smoke.py``'s k5
    phase). Raises off CUDA: it has no plain version."""
    kernel = "wgrad3x3 (mma.sync)"
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{kernel} runs float32 CUDA tensors, not {x.dtype} on {x.device}")
    _check_wgrad(kernel, x, g, scale, shift, prologue)
    dw, db = _wgrad_outputs(x, g)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_(), db.zero_()
    _build.check(_wgrad_mma_sync(x, g, scale, shift, prologue, dw, db), kernel)
    return dw, db


def _check_dgrad(kernel: str, g, x, weight, scale, shift, prologue: bool) -> None:
    check_tensors(kernel, g.device, g=g, x=x, weight=weight)
    check_tensors(kernel, g.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    if g.ndim != 4 or x.ndim != 4 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"{kernel}: input {tuple(x.shape)} and cotangent {tuple(g.shape)} "
                         "are not one NCHW conv's")
    cout, cin = g.shape[1], x.shape[1]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"{kernel}: weight {tuple(weight.shape)} is not ({cout}, {cin}, 3, 3)")
    if prologue:
        check_prologue(kernel, scale, shift, cin)


def _dgrad_outputs(x):
    return (torch.empty_like(x),
            torch.zeros((2, x.shape[1]), dtype=torch.float32, device=x.device))


def _dgrad_cp_async(g, x, weight, scale, shift, prologue: bool, dx, red) -> int:
    b, cin, h, w = x.shape
    lib = _build.library()
    scratch = (torch.empty((lib.im2im_dgrad3x3_scratch(b, cin, h, w),), dtype=torch.float32,
                           device=x.device) if prologue else None)
    return lib.im2im_dgrad3x3(
        g.data_ptr(), weight.data_ptr(), x.data_ptr(),
        scale.data_ptr() if prologue else None, shift.data_ptr() if prologue else None,
        dx.data_ptr(), scratch.data_ptr() if prologue else None, red.data_ptr(),
        b, cin, g.shape[1], h, w, int(prologue), x.device.index, stream_of(x),
    )


def _dgrad_tma(plan: DgradF32Plan, g, x, weight, scale, shift, prologue: bool, dx, red) -> int:
    b, cin, h, w = x.shape
    cout = g.shape[1]
    lib = _build.library()
    wpack = torch.empty((lib.im2im_dgrad3x3_tma_scratch(cin, cout),), dtype=torch.float32,
                        device=x.device)
    part = (torch.empty((plan.per_slice * 2 * cin,), dtype=torch.float32, device=x.device)
            if prologue else None)
    return lib.im2im_dgrad3x3_tma(
        g.data_ptr(), weight.data_ptr(), x.data_ptr(),
        scale.data_ptr() if prologue else None, shift.data_ptr() if prologue else None,
        dx.data_ptr(), wpack.data_ptr(), part.data_ptr() if prologue else None, red.data_ptr(),
        b, cin, cout, h, w, int(prologue), plan.th, plan.tw, plan.hc, plan.rows, plan.stages,
        plan.per_slice, x.device.index, stream_of(x),
    )


def _launch_dgrad(g, x, weight, scale, shift, prologue: bool):
    _check_dgrad("dgrad3x3", g, x, weight, scale, shift, prologue)
    dx, red = _dgrad_outputs(x)
    if x.numel() == 0:
        return dx, red
    if g.shape[1] == 0:
        return dx.zero_(), red
    if dgrad_f32_uses_tma(g, x):
        b, cin, h, w = x.shape
        plan = dgrad_f32_plan(b, cin, g.shape[1], h, w, sm_count(x.device.index))
        err = _dgrad_tma(plan, g, x, weight, scale, shift, prologue, dx, red)
        dgrad3x3.tma.launches += 1
    else:
        err = _dgrad_cp_async(g, x, weight, scale, shift, prologue, dx, red)
    dgrad3x3.launches += 1
    _build.check(err, "dgrad3x3")
    return dx, red


def dgrad3x3_cp_async(
    g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's ``cp.async``-fed kernel on K3/K4's ``m64n32`` core
    (``csrc/dgrad3x3.cu``) on float32 CUDA tensors whatever
    :func:`dgrad_f32_uses_tma` says, counted on no wrapper: the path of the
    shapes off the plan, run on the TMA path's shapes to compare the two
    (``chip_smoke.py``'s k6 phase). Raises off CUDA: it has no plain
    version."""
    kernel = "dgrad3x3 (cp.async)"
    if g.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{kernel} runs float32 CUDA tensors, not {x.dtype} on {g.device}")
    _check_dgrad(kernel, g, x, weight, scale, shift, prologue)
    dx, red = _dgrad_outputs(x)
    if x.numel() == 0:
        return dx, red
    if g.shape[1] == 0:
        return dx.zero_(), red
    _build.check(_dgrad_cp_async(g, x, weight, scale, shift, prologue, dx, red), kernel)
    return dx, red


def wgrad3x3(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dW (Cout, Cin, 3, 3) and db (Cout,), float32, of the 3×3 conv whose
    input is ``x`` (raw, before the prologue) and whose cotangent is ``g``.

    The kernel on a CUDA tensor, the plain version on a CPU tensor; any
    other device raises.
    """
    if x.device.type == "cuda":
        if x.dtype == torch.bfloat16:
            return wgrad3x3_nhwc(x, cotangent_nhwc(g, None, None), g.shape[1], scale, shift,
                                 prologue)
        return _launch_wgrad(x, g, scale, shift, prologue)
    if x.device.type == "cpu":
        return wgrad3x3_plain(x, g, scale, shift, prologue)
    raise RuntimeError(f"wgrad3x3 runs on cuda or cpu tensors, not {x.device}")


def dgrad3x3(
    g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dx (B, Cin, H, W) and red = (Σ dam·x, Σ dam) (2, Cin) of the 3×3
    conv with forward ``weight`` (Cout, Cin, 3, 3) for the cotangent ``g``.

    The kernel on a CUDA tensor, the plain version on a CPU tensor; any
    other device raises.
    """
    if g.device.type == "cuda":
        if x.dtype == torch.bfloat16:
            return dgrad3x3_nhwc(cotangent_nhwc(g, None, None), x, weight, scale, shift,
                                 prologue)
        return _launch_dgrad(g, x, weight, scale, shift, prologue)
    if g.device.type == "cpu":
        return dgrad3x3_plain(g, x, weight, scale, shift, prologue)
    raise RuntimeError(f"dgrad3x3 runs on cuda or cpu tensors, not {g.device}")


def cotangent_nhwc(gy: torch.Tensor, y: Optional[torch.Tensor],
                   gst: Optional[torch.Tensor]) -> torch.Tensor:
    """The cotangent that the bf16 K5 and K6 read, (B, H, W,
    padded_channels(C)) bf16: with the stats' cotangent ``gst`` (B, 2, C)
    and the forward's output ``y``, g = bf16((f32(gy) + gs) + 2·f32(y)·gq),
    else gy (:func:`cotangent_plain`). The kernel on a CUDA tensor (bf16
    only), the plain version on a CPU tensor; any other device raises."""
    if gy.device.type == "cuda":
        return _launch_cotangent(gy, y, gst)
    if gy.device.type == "cpu":
        return cotangent_plain(gy, y, gst)
    raise RuntimeError(f"cotangent_nhwc runs on cuda or cpu tensors, not {gy.device}")


def activation_nhwc(x: torch.Tensor, scale: Optional[torch.Tensor],
                    shift: Optional[torch.Tensor], prologue: bool) -> torch.Tensor:
    """The activation that the bf16 K3/K4 and K5 read, (B, H, W,
    padded_channels(C)) bf16: bf16(relu(f32(x)·scale + shift)) with the
    prologue, else x (:func:`activation_plain`). The kernel
    (``im2im_nhwc_pass`` mode 0) on a CUDA tensor (bf16 only), the plain
    version on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _launch_activation(x, scale, shift, prologue)
    if x.device.type == "cpu":
        return activation_plain(x, scale, shift, prologue)
    raise RuntimeError(f"activation_nhwc runs on cuda or cpu tensors, not {x.device}")


def wgrad3x3_nhwc(
    x: torch.Tensor, gp: torch.Tensor, cout: int, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dW (Cout, Cin, 3, 3) and db (Cout,), f32, of K5 in bf16 from the NHWC
    cotangent ``gp`` of :func:`cotangent_nhwc` (``cout`` channels) and the
    raw input ``x``: the kernel on a CUDA tensor (the activation written
    NHWC first; the stem, Cin = 1, on its own kernel),
    :func:`wgrad3x3_plain` on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _launch_wgrad_nhwc(x, gp, cout, scale, shift, prologue)
    if x.device.type == "cpu":
        return wgrad3x3_nhwc_plain(x, gp, cout, scale, shift, prologue)
    raise RuntimeError(f"wgrad3x3 runs on cuda or cpu tensors, not {x.device}")


def dgrad3x3_nhwc(
    gp: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, red) of K6 in bf16 from the NHWC cotangent ``gp`` of
    :func:`cotangent_nhwc`: the kernel on a CUDA tensor,
    :func:`dgrad3x3_plain` on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _launch_dgrad_nhwc(gp, x, weight, scale, shift, prologue)
    if x.device.type == "cpu":
        return dgrad3x3_nhwc_plain(gp, x, weight, scale, shift, prologue)
    raise RuntimeError(f"dgrad3x3 runs on cuda or cpu tensors, not {x.device}")


wgrad3x3.launches = 0  # K5 kernel launches since the last reset (f32)
# the f32 launches on the TMA path (csrc/wgrad3x3_tma.cu), also counted above
wgrad3x3.tma = types.SimpleNamespace(launches=0)
dgrad3x3.launches = 0  # K6 kernel launches since the last reset (f32)
# the f32 launches on the TMA path (csrc/dgrad3x3_tma.cu), also counted above
dgrad3x3.tma = types.SimpleNamespace(launches=0)
# the launches of the bf16 instances, counted apart
wgrad3x3.bf16 = types.SimpleNamespace(launches=0)
dgrad3x3.bf16 = types.SimpleNamespace(launches=0)
cotangent_nhwc.launches = 0  # launches of the bf16 cotangent pass
activation_nhwc.launches = 0  # launches of the bf16 activation pass
