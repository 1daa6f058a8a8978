"""Multi-seed sweep parallelism: train S independent replicas at once.

Counterpart of ``im2im_uq_tpu/training/multiseed.py``. JAX stacks S replicas
(one per seed) along a leading axis, shards that axis over the mesh and
``shard_map``\\ s the plain train step, so that each device trains its own
seeds with no cross-device communication. Here a replica is a model and its
optimizer (:class:`MultiseedStates`): :func:`init_multiseed_states` builds
one per seed, :func:`shard_multiseed_state` keeps each rank's contiguous
share of the seeds (S must divide over the ranks, as JAX's sharding needs),
and the step of :func:`make_multiseed_train_step` runs the port's plain
train step (``training/train.make_train_step`` without a mesh) on each local
replica in turn, on the same batch. It issues no collective, so a sweep of
S seeds over S GPUs costs one seed's wall clock, and each replica's numbers
are those of a one-process run of its seed. :func:`replica_state` fetches a
replica, as a plain ``UQState``, from the rank that holds it. Nothing else
in the port calls this module: it is library API, as in JAX.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from im2im_uq_tpu_torch.models.assembly import UQModel, UQState, add_uncertainty, build_trunk
from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.parallel.mesh import Mesh
from im2im_uq_tpu_torch.training.train import make_train_step

__all__ = [
    "MultiseedStates", "init_multiseed_states", "make_multiseed_train_step", "replica_state",
    "shard_multiseed_state",
]


@dataclasses.dataclass
class MultiseedStates:
    """Replicas of one model, one per seed: those this process holds,
    ``models[i]`` and ``optimizers[i]`` for ``seeds[first + i]``; every
    seed, in order, in ``seeds``; the optimizer factory they were made
    with; and the mesh their seeds are spread over (None: all held here)."""

    seeds: tuple[int, ...]
    models: list[UQModel]
    optimizers: list[torch.optim.Optimizer]
    optimizer: Callable
    first: int = 0
    mesh: Optional[Mesh] = None

    @property
    def local_seeds(self) -> tuple[int, ...]:
        return self.seeds[self.first:self.first + len(self.models)]


def init_multiseed_states(uq_state: UQState, seeds, optimizer: Callable,
                          example_input: torch.Tensor) -> MultiseedStates:
    """One replica of ``uq_state``'s model (rebuilt from its config) per
    seed, its weights drawn by torch's default init from a CPU
    ``torch.Generator`` seeded with the seed (what
    ``add_uncertainty(..., generator=torch.Generator().manual_seed(seed))``
    gives), placed on ``example_input``'s device; and its optimizer,
    ``optimizer(model.parameters())`` (e.g. ``lambda p:
    torch.optim.Adam(p, lr)``), the counterpart of the optax
    transformation JAX takes. ``example_input`` gives JAX's init its shapes;
    torch's modules know theirs, so here it gives only the device."""
    models, optimizers = [], []
    for seed in seeds:
        state = add_uncertainty(build_trunk(uq_state.params), uq_state.params,
                                generator=torch.Generator().manual_seed(int(seed)),
                                device=example_input.device)
        models.append(state.model)
        optimizers.append(optimizer(state.model.parameters()))
    return MultiseedStates(seeds=tuple(int(s) for s in seeds), models=models,
                           optimizers=optimizers, optimizer=optimizer)


def shard_multiseed_state(states: MultiseedStates, mesh: Optional[Mesh]) -> MultiseedStates:
    """``states`` with only this rank's contiguous share of the seeds kept:
    rank r holds seeds [r·S/n, (r + 1)·S/n) of the n ranks. The number of
    seeds must divide by the ranks. A mesh of one rank, or none, keeps
    them all."""
    mesh_lib.check_mesh(mesh)
    if not mesh_lib.spans(mesh):
        return states
    if states.mesh is not None or len(states.models) != len(states.seeds):
        raise ValueError("shard the states of init_multiseed_states once")
    s = len(states.seeds)
    if s % mesh.size:
        raise ValueError(f"{s} seeds must divide over the mesh's {mesh.size} ranks")
    k = s // mesh.size
    lo = mesh.rank * k
    return dataclasses.replace(states, models=states.models[lo:lo + k],
                               optimizers=states.optimizers[lo:lo + k], first=lo, mesh=mesh)


def make_multiseed_train_step(uq_state: UQState, optimizer: Callable,
                              mesh: Optional[Mesh]) -> Callable:
    """The multi-seed step: ``step(states, x, y, mask)`` → (states, this
    rank's losses, one per local seed). Each local replica takes the
    port's plain train step (``make_train_step`` without a mesh, the
    config's loss and hyperparameters) on the same batch, in turn, in
    place; no collective is issued. ``mesh_lib.fetch(mesh, losses)`` gives
    every seed's loss in seed order. ``states`` must come from
    ``optimizer`` and be sharded over ``mesh``."""
    mesh_lib.check_mesh(mesh)
    loss_pe = head_loss_pe_fn(uq_state.uncertainty_type)
    hyper = dict(uq_state.params, watch_gradients=False)
    mesh = mesh if mesh_lib.spans(mesh) else None

    def step(states: MultiseedStates, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
        if states.optimizer is not optimizer or states.mesh != mesh:
            raise ValueError("the states were made with another optimizer or sharded over "
                             "another mesh")
        losses = [make_train_step(model, loss_pe, hyper, opt)(x, y, mask)
                  for model, opt in zip(states.models, states.optimizers)]
        return states, torch.stack(losses)

    return step


def replica_state(uq_state: UQState, states: MultiseedStates, s: int) -> UQState:
    """Replica ``s`` (an index into ``states.seeds``) as a plain
    ``UQState`` on this process's device, for calibration or evaluation: a
    copy, which later steps leave as it is. Over a mesh every rank calls it
    and the rank that holds the replica broadcasts its weights and
    statistics."""
    if not 0 <= s < len(states.seeds):
        raise IndexError(f"replica {s} of {len(states.seeds)}")
    mesh = states.mesh
    if mesh is None:
        return uq_state.replace(model=copy.deepcopy(states.models[s]))
    k = len(states.models)
    owner = s // k
    local = s - states.first
    model = copy.deepcopy(states.models[local if owner == mesh.rank else 0])
    with torch.no_grad():
        for t in model.state_dict().values():
            mesh.broadcast_(t, src=owner)
    return uq_state.replace(model=model)
