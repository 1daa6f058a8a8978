"""Spatial (height-axis) sharding for very large tiles.

Counterpart of ``im2im_uq_tpu/parallel/spatial.py``. For inference on a tile
whose activations outgrow one GPU, each image's rows are split over the
ranks of a mesh (one process per GPU, ``parallel/mesh.py``) and every rank
runs the model on its slab. Where JAX's partitioner inserts the halo
exchanges itself, the port issues them by hand, in a fixed order, with
point-to-point sends of boundary rows (``mesh.exchange_rows``), inside
:func:`height_sharded`, the context that switches them on as
``models/unet.global_batch`` switches on the BatchNorm all-reduces:

- the rows: blocks of 2^d rows, d the model's 2x pools (:data:`POOLS`, 4
  for the UNet and WNet), split over the ranks as evenly as possible, the
  first ranks taking one more where they do not divide; the last rank also
  takes the H mod 2^d rows left over (:func:`row_spans`). Every slab
  boundary then falls on a pool window's, so the 2x2 max pool needs no
  exchange, and a rank's rows at pool level l are its rows at level 0
  shifted right by l bits. A rank whose share is empty still takes part in
  every collective and launches every kernel, on one row of zeros;
- a 3x3 conv (``DoubleConv``, the heads) runs on the slab plus one halo
  row from each neighbour and keeps the slab's rows (:func:`halo_conv`).
  At the image's top and bottom no row is added: the conv's own zero
  padding stands there, after K4's prologue under ``pallas_fused``, whose
  halo rows are exchanged before it (they are K4's input) and activated in
  the kernel like every other row;
- the align-corners upsample takes its taps in global coordinates
  (``ops/resize.axis_taps``): a rank's output rows read its slab and at
  most one row on each side. Under ``resize_backend`` "auto" and "xla" the
  XLA form runs over that window, as JAX runs its XLA form on a mesh of
  several devices. Under "pallas", where the global shape takes K1, JAX
  runs the bare kernel, which its partitioner all-gathers; here the layer's
  input is gathered openly, K1f runs over the whole height and the rank
  keeps its rows: each rank then holds the whole input and output of that
  layer, B·C·H·W/4 and B·C·H·W elements for the last ``Up`` (C = 64).
  ``Up``'s centre pad adds its rows at the image's edges: the last rank's
  bottom rows;
- BatchNorm in eval mode is per pixel and exchanges nothing. Training is
  not height-sharded, here or in JAX: a DoubleConv in train mode under the
  context raises.

The layout of a tensor is read from its width, which is not sharded: the
model's widths W, W/2, ..., W/2^d are distinct for W ≥ 2^d.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Callable, Optional

import torch

from im2im_uq_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_rows
from im2im_uq_tpu_torch.ops.upsample import pallas_upsample_eligible, upsample2x
from im2im_uq_tpu_torch.parallel.mesh import Mesh, check_mesh, exchange_rows, replicate_tree, spans

if TYPE_CHECKING:
    from im2im_uq_tpu_torch.models.assembly import UQState

__all__ = [
    "POOLS", "HeightSharding", "Rows", "active", "halo_conv", "height_sharded", "row_spans",
    "spatial_nested_sets", "spatial_sharded_forward",
]

# the 2x max pools between the UNet's (and WNet's) input and its deepest level
POOLS = 4


def row_spans(height: int, ranks: int, pools: int = POOLS) -> tuple[tuple[int, int], ...]:
    """Each rank's rows [start, stop) of an image ``height`` rows high: the
    2^pools-row blocks split as evenly as possible, the first ranks taking
    one more, and the rows past the last whole block to the last rank."""
    block = 1 << pools
    base, extra = divmod(height // block, ranks)
    out, start = [], 0
    for r in range(ranks):
        stop = height if r == ranks - 1 else start + (base + (r < extra)) * block
        out.append((start, stop))
        start = stop
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows of one tensor over the ranks: its global height and each
    rank's [start, stop)."""

    height: int
    spans: tuple[tuple[int, int], ...]

    def neighbours(self, rank: int) -> tuple[Optional[int], Optional[int]]:
        """The nearest ranks above and below ``rank`` whose share is not
        empty; (None, None) for a rank with an empty share."""
        nonempty = [q for q, (a, b) in enumerate(self.spans) if b > a]
        if rank not in nonempty:
            return None, None
        i = nonempty.index(rank)
        return (nonempty[i - 1] if i > 0 else None,
                nonempty[i + 1] if i + 1 < len(nonempty) else None)


@dataclasses.dataclass
class HeightSharding:
    """The mesh whose ranks split the rows, and the layout of each tensor
    width the model makes (level l: width W >> l)."""

    mesh: Mesh
    layouts: dict

    def rows(self, t: torch.Tensor) -> Rows:
        try:
            return self.layouts[t.shape[-1]]
        except KeyError:
            raise ValueError(f"no row layout for a tensor {t.shape[-1]} wide under the height "
                             f"sharding of widths {sorted(self.layouts)}") from None

    def span(self, t: torch.Tensor) -> tuple[int, int]:
        return self.rows(t).spans[self.mesh.rank]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global NCHW ``x``."""
        a, b = self.span(x)
        return x[:, :, a:b]

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's rows of ``t`` (along ``dim``) in rank order: the
        global tensor, on every rank. The slabs are padded to the largest
        for the all-gather and cut back."""
        counts = [b - a for a, b in self.rows(t).spans]
        most = max(counts)
        t = t.movedim(dim, 0)
        if t.shape[0] < most:
            t = torch.cat([t, t.new_zeros((most - t.shape[0], *t.shape[1:]))])
        parts = self.mesh.all_gather(t)
        full = torch.cat([parts[r * most:r * most + k] for r, k in enumerate(counts)])
        return full.movedim(0, dim)

    def window(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(this rank's rows of ``x`` with one neighbour row above and below
        where there is one, the global row of its first row)."""
        above, below = self.rows(x).neighbours(self.mesh.rank)
        ((top, bottom),) = exchange_rows(self.mesh, [x], above, below)
        rows = torch.cat([r for r in (top, x, bottom) if r is not None], 2)
        return rows, self.span(x)[0] - (top is not None)

    def conv(self, fn: Callable, xs: tuple) -> torch.Tensor:
        """:func:`halo_conv` under this sharding."""
        h = xs[0].shape[2]
        if h == 0:
            # an empty share: the conv of one row of zeros, cut to none
            return _cut(fn(*(x.new_zeros((*x.shape[:2], 1, x.shape[3])) for x in xs)), 0, 0)
        above, below = self.rows(xs[0]).neighbours(self.mesh.rank)
        halos = exchange_rows(self.mesh, xs, above, below)
        ext = [torch.cat([r for r in (top, x, bottom) if r is not None], 2)
               for x, (top, bottom) in zip(xs, halos)]
        lo = int(above is not None)
        return _cut(fn(*ext), lo, lo + h)

    def upsample2x(self, x: torch.Tensor, skip: torch.Tensor, backend: str) -> torch.Tensor:
        """This rank's rows of ``Up``'s 2x align-corners upsample of ``x``,
        centre-padded in height to ``skip``'s rows (the width is ``Up``'s
        to pad); module docstring."""
        n, m = self.rows(x).height, self.rows(skip).height
        a, b = self.span(skip)
        top = (m - 2 * n) // 2
        u0, u1 = (min(max(v - top, 0), 2 * n) for v in (a, b))
        bsz, c, _, w = x.shape
        if backend == "pallas" and pallas_upsample_eligible((bsz, n, w, c), x.dtype):
            up = upsample2x(self.gather(x, 2).contiguous())[:, :, u0:u1]
        else:
            rows, offset = self.window(x)
            up = resize_rows(rows, offset, n, 2 * n, u0, u1)
            up = resize_bilinear_align_corners(up, (up.shape[2], 2 * w))
        before = max(0, min(top, b) - a)
        after = (b - a) - before - (u1 - u0)
        return torch.cat([up.new_zeros((bsz, c, before, 2 * w)), up,
                          up.new_zeros((bsz, c, after, 2 * w))], 2)

    def resize(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        """This rank's rows of ``UpNoSkip``'s resize of ``x`` by an integer
        ``scale``: rows [scale·a, scale·b) for x's rows [a, b), a layout it
        records for its output's width."""
        src = self.rows(x)
        n, w = src.height, x.shape[3]
        dst = Rows(n * scale, tuple((a * scale, b * scale) for a, b in src.spans))
        if self.layouts.setdefault(w * scale, dst) != dst:
            raise ValueError(f"a {w * scale}-wide tensor already has another row layout")
        rows, offset = self.window(x)
        a, b = dst.spans[self.mesh.rank]
        up = resize_rows(rows, offset, n, n * scale, a, b)
        return resize_bilinear_align_corners(up, (up.shape[2], w * scale))


def _cut(out, lo: int, hi: int):
    """Rows [lo, hi) of a conv's output, or of the first element of a
    tuple of outputs (K4's (y, stats), whose stats are None in eval)."""
    if isinstance(out, tuple):
        return (out[0][:, :, lo:hi].contiguous(), *out[1:])
    return out[:, :, lo:hi].contiguous()


_active: Optional[HeightSharding] = None


def active() -> Optional[HeightSharding]:
    """The height sharding the model runs under, or None."""
    return _active


@contextlib.contextmanager
def height_sharded(mesh: Optional[Mesh], height: int, width: int, pools: int = POOLS):
    """Inside, the model runs on this rank's rows of an image ``height`` by
    ``width`` and exchanges rows with its neighbours (module docstring);
    yields the :class:`HeightSharding`, or None (and changes nothing) for a
    mesh of one rank or none."""
    global _active
    check_mesh(mesh)
    if not spans(mesh):
        yield None
        return
    if width >> pools < 1:
        raise ValueError(f"a height-sharded forward needs a width of at least {1 << pools} "
                         f"({pools} pools), got {width}")
    level0 = row_spans(height, mesh.size, pools)
    layouts = {width >> lv: Rows(height >> lv, tuple((a >> lv, b >> lv) for a, b in level0))
               for lv in range(pools + 1)}
    saved, _active = _active, HeightSharding(mesh, layouts)
    try:
        yield _active
    finally:
        _active = saved


def halo_conv(fn: Callable, *xs: torch.Tensor):
    """``fn(*xs)`` for a 3x3 same-padded conv ``fn`` of NCHW inputs (or a
    function returning the conv's output first): under
    :func:`height_sharded` each input gets its neighbours' boundary rows and
    the output is cut back to this rank's rows (module docstring);
    otherwise ``fn(*xs)`` as it is."""
    if _active is None:
        return fn(*xs)
    return _active.conv(fn, xs)


def spatial_sharded_forward(uq_state: "UQState", mesh: Optional[Mesh]) -> Callable:
    """The eval forward with each image's rows split over ``mesh``'s ranks:
    ``fn(x)`` of a global NCHW batch ``x`` on this rank's device → the head
    output (B, K, C, H, W), gathered on every rank. For single large tiles,
    where the batch has nothing to split. Every rank calls it (the model's
    weights are broadcast from rank 0 here), and every rank calls ``fn``."""
    check_mesh(mesh)
    model = uq_state.model
    replicate_tree(mesh, model)

    def forward(x: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode(), height_sharded(mesh, *x.shape[2:]) as sh:
            if sh is None:
                return model(x)
            return sh.gather(model(sh.take(x)), 3)

    return forward


def spatial_nested_sets(uq_state: "UQState", mesh: Optional[Mesh], lam=None) -> Callable:
    """(lower, pred, upper) for a giant tile, computed height-sharded:
    ``fn(x)`` → each (B, C, H, W), gathered on every rank (as
    :func:`spatial_sharded_forward`)."""
    if lam is None:
        if uq_state.lhat is None:
            raise ValueError("calibrate first or pass an explicit lam")
        lam = uq_state.lhat
    check_mesh(mesh)
    model = uq_state.model
    replicate_tree(mesh, model)

    def sets(x: torch.Tensor):
        model.eval()
        with torch.inference_mode(), height_sharded(mesh, *x.shape[2:]) as sh:
            if sh is None:
                return uq_state.nested_sets_from_output(model(x), lam)
            out = uq_state.nested_sets_from_output(model(sh.take(x)), lam)
            return tuple(sh.gather(t, 2) for t in out)

    return sets
