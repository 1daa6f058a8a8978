"""UNet and WNet trunks with a bilinear decoder, NCHW.

Counterpart of ``im2im_uq_tpu/models/unet.py`` (``DoubleConv``, ``Down``,
``Up``, ``UpNoSkip``, ``UNet``, ``WNet``), and of the reference trunks it
rebuilds. The submodule names are the reference's (``inc.double_conv.0``,
``down1.maxpool_conv.1``, ``up1.conv``, ``out.conv``; WNet's encoders
``p1inc``, ``p2down1``, ...), which are exactly the keys of
``interop/from_jax.state_dict_from_jax``, so a JAX model's weights load with
``load_state_dict(strict=True)`` under every ``conv_backend``.

``conv_backend`` picks how a ``DoubleConv`` runs its two 3×3 convs; the
``nn.Conv2d`` and ``nn.BatchNorm2d`` modules hold the parameters and buffers
in every case:

- ``"xla"``: PyTorch's own layers (cuDNN on the card, as the JAX package
  leaves them to XLA);
- ``"pallas"``: every 3×3 conv is K3 (``ops/conv.conv3x3``), followed by
  ``nn.BatchNorm2d`` and ReLU (``unet.py:429-485``);
- ``"pallas_fused"``: the JAX ``DoubleConv._fused`` (``unet.py:594-658``):
  conv0 is K4 with a stats epilogue, bn0 folds into conv1's K4 prologue, and
  only bn1's affine + ReLU runs as elementwise work; K5 and K6 are the
  backward. The folded BatchNorm is :func:`fold_batchnorm`.

``dtype`` is the compute dtype, float32 or bfloat16 (``compute_dtype`` of
the config), as the JAX modules' ``dtype`` is: the parameters and the
BatchNorm running statistics stay float32, and each conv casts its input,
weight and bias to ``dtype`` first (the JAX ``promote_dtype`` calls,
``unet.py:440-518,863-873``), so the activations between the convs are
``dtype``. In bfloat16, BatchNorm is :func:`batch_norm_low_precision`,
flax's: statistics reduced in float32, the affine in float32, one rounding.
Under ``pallas_fused`` the folded scale and shift stay float32.

``remat`` (the UNet's; WNet takes none, as in JAX) is activation
checkpointing, the JAX ``nn.remat`` of the blocks under three policies
(``unet.py:815-833``), expressed by which sub-function is checkpointed
(``torch.utils.checkpoint``, non-reentrant) rather than by tags: the port's
kernels run through ctypes, where no dispatcher op marks their outputs.

- ``"full"``: each of ``inc``, ``down1-4`` and ``up1-4`` is checkpointed
  whole; only the blocks' inputs survive to the backward.
- ``"conv"``: only conv, pool and resize outputs survive. In a DoubleConv of
  ``xla`` and ``pallas``, bn0 + ReLU + conv1 is one checkpointed region
  over conv0's output and bn1 + ReLU another over conv1's; the recompute
  runs conv1's forward again, where JAX keeps its output. The fused
  DoubleConv tags no conv output in JAX (``unet.py:594-658``), so under
  ``pallas_fused`` the whole DoubleConv is checkpointed and only the pool
  and resize outputs before it survive.
- ``"bn"``: everything survives except the post-BN/ReLU tensor inside a
  DoubleConv (conv1's input): bn0 + ReLU + conv1 is checkpointed. Under
  ``pallas_fused`` nothing carries the tag, so nothing is checkpointed.

Every mode computes the same function as off, and a recompute does not move
the BatchNorm running statistics again (:func:`checkpointed`).

Under :func:`global_batch` (a data-parallel train step over several ranks,
``parallel/mesh.py``) every BatchNorm in train mode normalises over the
global batch, as GSPMD's program does in a JAX mesh step: the per-channel
sums of each rank's shard are summed over the ranks by a differentiable
all-reduce (so the cotangents of the statistics are the global ones too),
the element count is the global one, and the running statistics move with
the global unbiased variance. ``batch_norm`` takes Σx, then Σ(x − mean)²;
``batch_norm_low_precision`` Σx and Σx² (flax's fast variance); under
``pallas_fused`` K4's per-image stats (Σy, Σy²) are reduced before they
fold. A checkpointed region's recompute issues the same collectives again
inside the backward.

Under ``parallel/spatial.height_sharded`` (an eval forward with each image's
rows split over the ranks) every 3×3 conv runs on its slab plus the
neighbours' halo rows (``spatial.halo_conv``; under ``pallas_fused`` the
exchange is of K4's input, before its prologue), and ``Up`` and ``UpNoSkip``
take their resize's taps in global coordinates (``spatial.HeightSharding``);
the pool and BatchNorm exchange nothing.

An ``Up`` hands its conv the pair (skip, upsampled) and the conv0 of
``pallas`` and ``pallas_fused`` runs as two K3 calls over the two halves of
the kernel, so the concatenation is never built (``unet.py:615-629,
737-743``). The decoder's 2x upsample routes by shape and
``resize_backend`` as the JAX ``Up``'s does
(``ops/resize.upsample2x_align_corners``): K1 (``ops/upsample.py``: K1f
forward, K1b backward) where the TPU kernel takes the shape, the XLA form
in PyTorch ops elsewhere (at 320², up1's 20×20 input). ``Down``'s pool is
``ops/pool.MaxPool2x2``: torch's max-pool forward, K7 as its backward.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from im2im_uq_tpu_torch.ops.conv import conv3x3, conv3x3_bn_act
from im2im_uq_tpu_torch.ops.pool import MaxPool2x2
from im2im_uq_tpu_torch.ops.resize import resize_bilinear_align_corners, upsample2x_align_corners
from im2im_uq_tpu_torch.parallel import spatial
from im2im_uq_tpu_torch.parallel.mesh import all_reduce_sum, spans

__all__ = [
    "CONV_BACKENDS", "REMAT_MODES", "DoubleConv", "Down", "OutConv", "UNet", "Up", "UpNoSkip",
    "WNet", "batch_norm", "batch_norm_low_precision", "checkpointed", "compute_cast",
    "fold_batchnorm", "global_batch",
]

CONV_BACKENDS = ("xla", "pallas", "pallas_fused")
REMAT_MODES = (False, "full", "conv", "bn")

# True while a checkpointed region is recomputed in the backward: the
# BatchNorm running statistics moved in its forward and stay as they are
_recomputing = False


# The mesh whose ranks' batches together are the batch that BatchNorm
# normalises over in train mode; None: this process's batch alone
_mesh = None


@contextlib.contextmanager
def _recompute(on: bool):
    global _recomputing
    saved, _recomputing = _recomputing, on
    try:
        yield
    finally:
        _recomputing = saved


@contextlib.contextmanager
def global_batch(mesh):
    """Train-mode BatchNorm inside normalises over the global batch of
    ``mesh``'s ranks (module docstring); a mesh of one rank, or None,
    changes nothing."""
    global _mesh
    saved, _mesh = _mesh, (mesh if spans(mesh) else None)
    try:
        yield
    finally:
        _mesh = saved


def _global_sums(*sums: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per-channel sums over the ranks of ``_mesh``, differentiably."""
    return tuple(all_reduce_sum(torch.stack(sums), _mesh).unbind(0))


def checkpointed(fn: Callable, *args: torch.Tensor):
    """``fn(*args)`` under activation checkpointing (non-reentrant): what
    ``fn`` saves for its backward is dropped and recomputed from ``args``
    there. The recompute is a second call of ``fn``; in it the BatchNorm
    running statistics are not moved (``batch_norm``,
    ``batch_norm_low_precision`` and ``fold_batchnorm`` read the flag), so a
    step moves them once. Without autograd ``fn`` runs as it is."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = []
    mesh = _mesh  # the recompute runs in the backward, outside the caller's scope

    def run(*a):
        with _recompute(bool(calls)), global_batch(mesh):
            calls.append(None)
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)

Pair = tuple[torch.Tensor, torch.Tensor]


def _bn(features: int) -> nn.BatchNorm2d:
    # torch's defaults, which the JAX package's TorchBatchNorm reproduces
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def compute_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in the compute dtype: cast to bf16 for a bf16 model; a float32
    model casts nothing, so that the whole model can run in f64."""
    return t if dtype == torch.float32 else t.to(dtype)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn(x)``; in a checkpointed region's recompute the same call on
    copies of the running statistics, so that they move once a step. In
    train mode under :func:`global_batch`, :func:`_sync_batch_norm`."""
    if bn.training and _mesh is not None:
        return _sync_batch_norm(bn, x)
    if not (bn.training and _recomputing):
        return bn(x)
    return F.batch_norm(x, bn.running_mean.clone(), bn.running_var.clone(), bn.weight, bn.bias,
                        True, bn.momentum, bn.eps)


def _sync_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Train-mode ``bn(x)`` over the global batch of ``_mesh``: mean =
    ΣΣx / n, var = ΣΣ(x − mean)² / n over the ranks' n elements per channel
    (two passes, as ``F.batch_norm`` takes the variance), the running
    statistics moved with the global unbiased variance."""
    n = x.numel() // x.shape[1] * _mesh.size
    (s,) = _global_sums(x.sum((0, 2, 3)))
    mean = s / n
    d = x - _per_channel(mean)
    (q,) = _global_sums((d * d).sum((0, 2, 3)))
    var = q / n
    if not _recomputing:
        _move_running_stats(bn, mean, var, n)
    return d * _per_channel(torch.rsqrt(var + bn.eps) * bn.weight) + _per_channel(bn.bias)


def batch_norm_low_precision(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm of a bf16 ``x`` as the JAX ``TorchBatchNorm`` computes it
    through flax's ``_compute_stats`` and ``_normalize`` (``unet.py:39-117``),
    with ``bn``'s float32 parameters and running statistics.

    Train: mean = E[x], var = max(0, E[x²] − mean²) (flax's fast variance),
    reduced in float32 from the bf16 values; the running statistics move in
    place, without gradient, by torch's momentum with the unbiased variance
    var·n/(n−1), and ``num_batches_tracked`` counts the step. Eval: the
    running statistics. Then ((x − mean)·(rsqrt(var + ε)·γ) + β) in float32,
    in flax's order, rounded once to ``x.dtype``. Under :func:`global_batch`
    E[x] and E[x²] are taken over the global batch."""
    xf = x.float()
    if train:
        n = x.numel() // x.shape[1]
        if _mesh is None:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        else:
            n *= _mesh.size
            s, q = _global_sums(xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)))
            mean = s / n
            var = torch.clamp(q / n - mean * mean, min=0.0)
        if not _recomputing:
            _move_running_stats(bn, mean, var, n)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - _per_channel(mean)) * _per_channel(mul) + _per_channel(bn.bias)
    return y.to(x.dtype)


def _move_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                        n: int) -> None:
    """torch's momentum update of the running statistics, in place and
    without gradient, with the unbiased variance var·n/(n−1); counts the step
    in ``num_batches_tracked`` as ``nn.BatchNorm2d`` does."""
    with torch.no_grad():
        bessel = n / (n - 1) if n > 1 else 1.0
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var * bessel)
        bn.num_batches_tracked.add_(1)


def fold_batchnorm(
    bn: nn.BatchNorm2d, sums: Optional[torch.Tensor], sumsqs: Optional[torch.Tensor], n: int,
    train: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``FusedBN`` (``unet.py:258-306``): BatchNorm folded to a
    per-channel (scale, shift) from its input's Σy and Σy² over ``n``
    elements per channel.

    Train: mean = Σ/n, var = Σy²/n − mean² (the fast-variance form), and the
    running statistics move in place, without gradient, by torch's momentum
    with the unbiased variance var·n/(n−1); ``num_batches_tracked`` counts
    the step as ``nn.BatchNorm2d`` does. Eval: the running statistics.
    Then scale = γ·rsqrt(var + ε), shift = β − mean·scale. Under
    :func:`global_batch` the sums are this rank's and ``n`` its count: both
    are summed over the ranks first.
    """
    if train:
        if _mesh is not None:
            sums, sumsqs = _global_sums(sums, sumsqs)
            n *= _mesh.size
        mean = sums / n
        var = sumsqs / n - mean * mean
        if not _recomputing:
            _move_running_stats(bn, mean, var, n)
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    return scale, bn.bias - mean * scale


class DoubleConv(nn.Module):
    """(conv3x3 → BN → ReLU) × 2, run by ``conv_backend`` (module docstring).

    Its input is a tensor, or the pair (skip, upsampled) of an ``Up``,
    which stands for their concatenation along the channels. Each conv runs
    in ``dtype`` (module docstring). ``remat`` "conv" and "bn" checkpoint
    regions inside it (module docstring); "full" is the UNet's, per block.
    """

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None,
                 conv_backend: str = "xla", dtype: torch.dtype = torch.float32,
                 remat=False):
        super().__init__()
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(f"unknown conv_backend {conv_backend!r}")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        mid = mid_channels if mid_channels is not None else out_channels
        self.conv_backend = conv_backend
        self.dtype = dtype
        self.remat = remat
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, kernel_size=3, padding=1),
            _bn(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, kernel_size=3, padding=1),
            _bn(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: Union[torch.Tensor, Pair]) -> torch.Tensor:
        if self.training and spatial.active() is not None:
            raise ValueError("a height-sharded forward runs in eval mode only: train-mode "
                             "BatchNorm would normalise over this rank's rows")
        if self.conv_backend == "pallas_fused":
            if self.remat == "conv":
                # no conv output of the fused block survives (module docstring)
                args = x if isinstance(x, tuple) else (x,)
                return checkpointed(lambda *a: self._fused(a if len(a) == 2 else a[0]), *args)
            return self._fused(x)
        if self.conv_backend == "pallas":
            y0 = self._conv0_k3(x)
        else:
            if isinstance(x, tuple):
                x = torch.cat(x, dim=1)
            w, b = self._params(self.double_conv[0])
            y0 = spatial.halo_conv(
                lambda t: F.conv2d(compute_cast(t, self.dtype), w, b, padding=1), x)
        return self._rest(y0)

    def _conv1(self, y: torch.Tensor) -> torch.Tensor:
        w, b = self._params(self.double_conv[3])
        if self.conv_backend == "pallas":
            return spatial.halo_conv(lambda t: conv3x3(t, w, b), y)
        return spatial.halo_conv(lambda t: F.conv2d(t, w, b, padding=1), y)

    def _rest(self, y0: torch.Tensor) -> torch.Tensor:
        """bn0 → ReLU → conv1 → bn1 → ReLU of ``xla`` and ``pallas`` on conv0's
        output, the regions of ``remat`` checkpointed (module docstring)."""
        _, bn0, _, _, bn1, _ = self.double_conv

        def mid(t):
            return self._conv1(self._bn_relu(bn0, t))

        def end(t):
            return self._bn_relu(bn1, t)

        y1 = checkpointed(mid, y0) if self.remat in ("conv", "bn") else mid(y0)
        return checkpointed(end, y1) if self.remat == "conv" else end(y1)

    def _params(self, conv: nn.Conv2d) -> tuple[torch.Tensor, torch.Tensor]:
        """A conv's weight and bias in the compute dtype."""
        return compute_cast(conv.weight, self.dtype), compute_cast(conv.bias, self.dtype)

    def _bn_relu(self, bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
        """BatchNorm (torch's in f32, flax's in bf16), then ReLU in place on
        its fresh output, which neither backward reads."""
        if self.dtype == torch.float32:
            return F.relu(batch_norm(bn, y), inplace=True)
        return F.relu(batch_norm_low_precision(bn, y, self.training), inplace=True)

    def _conv0_k3(self, x: Union[torch.Tensor, Pair]) -> torch.Tensor:
        """conv0 through K3; over a pair, one K3 call per half of the
        kernel, the bias in the first."""
        weight, bias = self._params(self.double_conv[0])
        if not isinstance(x, tuple):
            return spatial.halo_conv(
                lambda t: conv3x3(compute_cast(t, self.dtype), weight, bias), x)
        ca = x[0].shape[1]
        return spatial.halo_conv(
            lambda a, b: (conv3x3(compute_cast(a, self.dtype), weight[:, :ca], bias)
                          + conv3x3(compute_cast(b, self.dtype), weight[:, ca:])), *x)

    def _fused(self, x: Union[torch.Tensor, Pair]) -> torch.Tensor:
        conv0, bn0, _, conv1, bn1, _ = self.double_conv
        train = self.training
        s0 = q0 = None
        if isinstance(x, tuple):
            # Σ(y_a + y_b)² is not a sum of per-half stats, so the halves
            # run K3 and the stats are reduced here, in f32 (unet.py:615-629)
            y0 = self._conv0_k3(x)
            if train:
                y0f = y0.to(torch.promote_types(y0.dtype, torch.float32))
                s0, q0 = y0f.sum((0, 2, 3)), (y0f * y0f).sum((0, 2, 3))
        else:
            w0, b0 = self._params(conv0)
            y0, st0 = spatial.halo_conv(
                lambda t: conv3x3_bn_act(compute_cast(t, self.dtype), w0, b0, None, None,
                                         prologue=False, stats=train), x)
            if train:
                s0, q0 = st0[:, 0].sum(0), st0[:, 1].sum(0)
        n = y0.shape[0] * y0.shape[2] * y0.shape[3]
        scale0, shift0 = fold_batchnorm(bn0, s0, q0, n, train)
        # K4's input, before its prologue, is what a height-sharded run exchanges
        w1, b1 = self._params(conv1)
        y1, st1 = spatial.halo_conv(
            lambda t: conv3x3_bn_act(t, w1, b1, scale0, shift0, prologue=True, stats=train), y0)
        s1, q1 = (st1[:, 0].sum(0), st1[:, 1].sum(0)) if train else (None, None)
        scale1, shift1 = fold_batchnorm(bn1, s1, q1, n, train)
        # the affine in f32 (a bf16 y1 promotes), rounded to y1's dtype
        return F.relu(y1 * _per_channel(scale1) + _per_channel(shift1)).to(y1.dtype)


class Down(nn.Module):
    """2×2 max pool (floor on odd sizes), then DoubleConv.

    The pool has no parameters, so the state-dict keys stay
    ``maxpool_conv.1.*``.
    """

    def __init__(self, in_channels: int, out_channels: int, conv_backend: str = "xla",
                 dtype: torch.dtype = torch.float32, remat=False):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            MaxPool2x2(),
            DoubleConv(in_channels, out_channels, conv_backend=conv_backend, dtype=dtype,
                       remat=remat),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """2x bilinear upsample, centre pad to the skip's size, then DoubleConv
    over [skip, up] along the channels."""

    def __init__(self, in_channels: int, out_channels: int, conv_backend: str = "xla",
                 dtype: torch.dtype = torch.float32, remat=False, resize_backend: str = "auto"):
        super().__init__()
        self.resize_backend = resize_backend
        self.conv = DoubleConv(in_channels, out_channels, in_channels // 2,
                               conv_backend=conv_backend, dtype=dtype, remat=remat)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        sharded = spatial.active()
        if sharded is None:
            x1 = upsample2x_align_corners(x1, self.resize_backend)
        else:  # this rank's rows, the height's centre pad included
            x1 = sharded.upsample2x(x1, x2, self.resize_backend)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            # left/top get diff // 2, right/bottom the rest (unet.py:729-736)
            x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        # the skip comes first: conv0's input-channel order depends on it
        return self.conv((x2, x1))


class UpNoSkip(nn.Module):
    """Bilinear upsample by any integer factor, then DoubleConv, without a
    skip connection (``unet.py:746``, the reference's unused Up_custom).
    The resize is the per-axis lerps in PyTorch ops, as the JAX module's
    (``ops/resize.resize_bilinear_align_corners``)."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = DoubleConv(in_channels, out_channels, in_channels // 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        s = self.scale_factor
        sharded = spatial.active()
        if sharded is not None:
            return self.conv(sharded.resize(x, s))
        return self.conv(resize_bilinear_align_corners(x, (h * s, w * s)))


class OutConv(nn.Module):
    """1×1 projection to the trunk's feature channels, in ``dtype``; its
    output stays in ``dtype`` for the head (``unet.py:863-875``)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(*(compute_cast(t, self.dtype)
                          for t in (x, self.conv.weight, self.conv.bias)))


class UNet(nn.Module):
    """4-down/4-up UNet, encoder 64/128/256/512/512, decoder 256/128/64/64,
    1×1 out-conv to ``n_channels_middle`` (32) features. Input (B, C, H, W);
    the features come out in ``dtype``. ``remat`` is one of REMAT_MODES
    (module docstring)."""

    def __init__(self, n_channels_in: int = 1, n_channels_out: int = 1,
                 n_channels_middle: int = 32, conv_backend: str = "xla",
                 dtype: torch.dtype = torch.float32, remat=False, resize_backend: str = "auto"):
        super().__init__()
        self.n_channels_out = n_channels_out
        self.n_channels_middle = n_channels_middle
        self.conv_backend = conv_backend
        self.dtype = dtype
        self.remat = remat
        cb, dt, rm = conv_backend, dtype, remat
        self.inc = DoubleConv(n_channels_in, 64, conv_backend=cb, dtype=dt, remat=rm)
        self.down1 = Down(64, 128, cb, dt, rm)
        self.down2 = Down(128, 256, cb, dt, rm)
        self.down3 = Down(256, 512, cb, dt, rm)
        self.down4 = Down(512, 512, cb, dt, rm)
        rb = resize_backend
        self.up1 = Up(1024, 256, cb, dt, rm, rb)
        self.up2 = Up(512, 128, cb, dt, rm, rb)
        self.up3 = Up(256, 64, cb, dt, rm, rb)
        self.up4 = Up(128, 64, cb, dt, rm, rb)
        self.out = OutConv(64, n_channels_middle, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # remat "full": each block checkpointed whole (unet.py:831-833)
        run = checkpointed if self.remat == "full" else (lambda block, *a: block(*a))
        x1 = run(self.inc, x)
        x2 = run(self.down1, x1)
        x3 = run(self.down2, x2)
        x4 = run(self.down3, x3)
        x5 = run(self.down4, x4)
        x = run(self.up1, x5, x4)
        x = run(self.up2, x, x3)
        x = run(self.up3, x, x2)
        x = run(self.up4, x, x1)
        return self.out(x)


class WNet(nn.Module):
    """Dual-encoder UNet for two-channel inputs (``unet.py:882``, reference
    wnet.py:9-59): input channels 0 and 1 each get their own encoder
    (DoubleConv 32, then Down 64/128/256/256, as ``p1*`` and ``p2*``); the
    decoder (Up 256/128/64/64) reads the two encoders' outputs concatenated
    per level, then a 1×1 out-conv to ``n_channels_middle`` (32) features.
    Input (B, ≥2, H, W); channels past the second are not read. The
    features come out in ``dtype``."""

    def __init__(self, n_channels_out: int = 1, n_channels_middle: int = 32,
                 conv_backend: str = "xla", dtype: torch.dtype = torch.float32,
                 resize_backend: str = "auto"):
        super().__init__()
        self.n_channels_out = n_channels_out
        self.n_channels_middle = n_channels_middle
        self.conv_backend = conv_backend
        self.dtype = dtype
        cb, dt = conv_backend, dtype
        for tag in ("p1", "p2"):
            setattr(self, f"{tag}inc", DoubleConv(1, 32, conv_backend=cb, dtype=dt))
            for i, (cin, cout) in enumerate(((32, 64), (64, 128), (128, 256), (256, 256)), 1):
                setattr(self, f"{tag}down{i}", Down(cin, cout, cb, dt))
        rb = resize_backend
        self.up1 = Up(1024, 256, cb, dt, resize_backend=rb)
        self.up2 = Up(512, 128, cb, dt, resize_backend=rb)
        self.up3 = Up(256, 64, cb, dt, resize_backend=rb)
        self.up4 = Up(128, 64, cb, dt, resize_backend=rb)
        self.out = OutConv(64, n_channels_middle, dt)

    def _encode(self, p: torch.Tensor, tag: str) -> list[torch.Tensor]:
        feats = [getattr(self, f"{tag}inc")(p)]
        for i in range(1, 5):
            feats.append(getattr(self, f"{tag}down{i}")(feats[-1]))
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self._encode(x[:, 0:1], "p1")
        b = self._encode(x[:, 1:2], "p2")
        cat = [torch.cat(pair, dim=1) for pair in zip(a, b)]
        x = self.up1(cat[4], cat[3])
        x = self.up2(x, cat[2])
        x = self.up3(x, cat[1])
        x = self.up4(x, cat[0])
        return self.out(x)
