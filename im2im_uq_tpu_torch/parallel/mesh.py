"""The data-parallel mesh as processes: batch shards, replication, collectives.

Counterpart of ``im2im_uq_tpu/parallel/mesh.py``. JAX's 1-D ``data`` mesh
becomes the ranks of a process group, one GPU each (:class:`Mesh`):

- every rank iterates the identical batch stream (the pipelines are seeded
  alike) and takes its contiguous slice of each global batch
  (:func:`put_batch`, :func:`shard_batch`), as JAX's ``put_batch`` hands
  each device its slice;
- parameters and BatchNorm buffers are broadcast from rank 0
  (:func:`replicate_tree`) and stay identical: every rank applies the same
  summed gradients;
- batch-sharded results come back in rank order, that is in the global
  batch's order (:func:`fetch`, an all-gather).

What GSPMD inserts in a JAX mesh program the port issues by hand: the
BatchNorm statistics over the global batch (``models/unet.py``), the
gradients summed and the loss normalised by the global mask count
(``training/train.py``), the calibration sums (``calibration/rcps.py``), and
for a height-sharded forward the boundary rows that each 3×3 conv and
upsample reads from its neighbours (:func:`exchange_rows`,
``parallel/spatial.py``).

A one-rank mesh, or none, is the one-device path exactly. Every backend
takes the collectives on the tensors' own device: NCCL on CUDA, gloo on
the CPU and also on CUDA (two ranks rehearsing on one GPU,
``parallel/distributed.py``; gloo's all-reduce, broadcast and all-gather
accept CUDA tensors in f32, f64, bf16, int64 and bool).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = [
    "DATA_AXIS", "Mesh", "all_reduce_sum", "check_mesh", "data_parallel_mesh", "exchange_rows",
    "fetch", "mesh_batch_size", "pad_to_multiple", "put_batch", "reduce_gradients",
    "replicate_tree", "shard_batch", "spans",
]

_ROUNDING_WARNED: set = set()

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of ``group`` (None: the default group) along the data
    axis: ``size`` of them, this process ``rank``, driving ``device``."""

    group: Any
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """Axis sizes, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.size}

    @property
    def is_main(self) -> bool:
        """Rank 0, which alone writes files."""
        return self.rank == 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``t``, into a new tensor (identical bits on
        every rank)."""
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` set in place to rank ``src``'s value."""
        dist.broadcast(t, src, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0 in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def barrier(self) -> None:
        """Wait, on the host, until every rank arrives (after rank 0's
        writes)."""
        self.all_reduce(torch.zeros((), device=self.device)).item()

    def agree(self, flag: bool) -> bool:
        """True on every rank when it is True on any."""
        return bool(self.all_reduce(torch.tensor(float(flag), device=self.device)) > 0)


def spans(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has more than one rank; one rank, or none, runs
    the one-device path."""
    return mesh is not None and mesh.size > 1


def check_mesh(mesh) -> None:
    """Raise TypeError unless ``mesh`` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, not {type(mesh).__name__}")


def data_parallel_mesh(device: torch.device | str = "cuda", group=None) -> Mesh:
    """The mesh over the ranks of ``group`` (default: every rank), or one
    rank outside a process group. A CUDA ``device`` without an index
    becomes GPU ``LOCAL_RANK`` (modulo the visible GPUs), made current."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % max(torch.cuda.device_count(), 1))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        return Mesh(group=None, size=1, rank=0, device=device)
    return Mesh(group=group, size=dist.get_world_size(group), rank=dist.get_rank(group),
                device=device)


def mesh_batch_size(batch_size: int, mesh: Optional[Mesh]) -> int:
    """Smallest multiple of the mesh's data-axis size ≥ ``batch_size``.

    GSPMD requires the sharded batch axis to divide evenly across the
    'data' axis; batches are padded to a fixed size with a validity mask
    anyway (data.core.pad_batch), so rounding the program's batch shape up
    costs only masked padding rows — a config batch_size of 78 on an
    8-device mesh runs as 80 with 2 masked slots, instead of crashing.
    """
    if mesh is None or DATA_AXIS not in mesh.shape:
        return batch_size
    n = mesh.shape[DATA_AXIS]
    rounded = -(-batch_size // n) * n
    if rounded != batch_size and (batch_size, n) not in _ROUNDING_WARNED:
        # visible, once per (batch, mesh) pair: full batches carry more real
        # examples per step than configured — a quiet hyperparameter change
        # vs the reference's training dynamics unless surfaced
        _ROUNDING_WARNED.add((batch_size, n))
        logging.getLogger(__name__).warning(
            "batch_size %d rounded up to %d (next multiple of the %d-device "
            "data axis); final shapes are padded+masked, but full batches "
            "will contain %d real examples per step",
            batch_size, rounded, n, rounded,
        )
    return rounded


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def _rows(mesh: Optional[Mesh], a):
    """This rank's contiguous slice of ``a`` along axis 0."""
    if not spans(mesh):
        return a
    n = a.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} ranks")
    k = n // mesh.size
    return a[mesh.rank * k:(mesh.rank + 1) * k]


def put_batch(mesh: Optional[Mesh], *arrays: np.ndarray) -> tuple:
    """This rank's slice of each host array of one global batch; the arrays
    themselves without a mesh."""
    return tuple(_rows(mesh, a) for a in arrays)


def shard_batch(mesh: Optional[Mesh], batch: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a global batch tensor."""
    return _rows(mesh, batch)


def replicate_tree(mesh: Optional[Mesh], tree) -> None:
    """Broadcast rank 0's values of a module's parameters and buffers (or
    of a list of tensors) to every rank, in place."""
    if not spans(mesh):
        return
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else list(tree))
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t.data)


def fetch(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """A batch-sharded tensor's global value on every rank: the shards in
    rank order."""
    return mesh.all_gather(t) if spans(mesh) else t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ of ``t`` over the ranks, differentiable: autograd carries the Σ of
    the output's cotangents back to every rank's ``t``."""
    return dist_nn.all_reduce(t, group=dist.group.WORLD if mesh.group is None else mesh.group)


def exchange_rows(mesh: Mesh, tensors, above: Optional[int], below: Optional[int]) -> list:
    """The halo rows of NCHW slabs split by height over the ranks: for each
    tensor, the pair (the last row of rank ``above``'s slab, the first row of rank
    ``below``'s), None where there is no such rank. This rank sends its
    first row to ``above`` and its last row to ``below``; every pair of
    neighbours posts the same sends and receives, tensor by tensor, in one
    batch of point-to-point operations (no order can deadlock). gloo's
    send and receive take host memory only, so under gloo a CUDA tensor's
    rows are staged through the host."""
    stage = any(t.is_cuda for t in tensors) and dist.get_backend(mesh.group) == "gloo"
    ops, recvs = [], []
    for t in tensors:
        pair = []
        for peer, row in ((above, t[:, :, :1]), (below, t[:, :, -1:])):
            if peer is None:
                pair.append(None)
                continue
            send = row.contiguous().cpu() if stage else row.contiguous()
            recv = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, peer, mesh.group),
                    dist.P2POp(dist.irecv, recv, peer, mesh.group)]
            pair.append(recv)
        recvs.append(pair)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [tuple(None if r is None else r.to(t.device) for r in pair)
            for t, pair in zip(tensors, recvs)]


def reduce_gradients(params, mesh: Optional[Mesh]) -> None:
    """Sum the parameters' ``.grad`` over the ranks, one collective per
    dtype, after the backward (a missing gradient counts as zeros)."""
    if not spans(mesh):
        return
    params = list(params)
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        grads = [p.grad for p in group]
        summed = mesh.all_reduce(_flatten_dense_tensors(grads))
        for p, g in zip(group, _unflatten_dense_tensors(summed, grads)):
            p.grad.copy_(g)
