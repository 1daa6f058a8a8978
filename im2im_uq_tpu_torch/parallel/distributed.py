"""Multi-process initialisation: one process per GPU, ``torch.distributed``.

Counterpart of ``im2im_uq_tpu/parallel/distributed.py``. A JAX process sees
every chip of its host and one mesh spans them; a PyTorch process drives one
GPU, so the mesh's data axis becomes the ranks of a process group
(``parallel/mesh.py``). The processes come from a launcher
(``python -m torch.distributed.run --nproc_per_node N -m ...``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) or from :func:`spawn_per_device`, which the entry points
call with ``--device cuda`` and more than one visible GPU and which sets the
same variables.

The backend is NCCL for CUDA devices and gloo for the CPU, or the one the
caller names: two ranks on one GPU (a rehearsal of the multi-GPU path on a
one-card machine) need gloo, since NCCL refuses two ranks on one device, and
the caller must ask for it. Nothing falls back to another backend.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from im2im_uq_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh

__all__ = [
    "DEFAULT_TIMEOUT", "free_port", "global_mesh", "init_distributed", "join_or_spawn",
    "launched", "process_shard_info", "spawn_per_device", "visible_devices",
]

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def launched() -> bool:
    """Whether a launcher started this process as one of several ranks."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: torch.device | str = "cuda",
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group (a no-op for one process, or when joined).

    The arguments default to the launcher's environment: ``WORLD_SIZE``,
    ``RANK`` and ``MASTER_ADDR:MASTER_PORT``. ``backend`` defaults to NCCL
    on a CUDA ``device`` and gloo on the CPU."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id, timeout=timeout)


def process_shard_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh():
    """The process group over every rank (the default group), or None
    outside one."""
    return dist.group.WORLD if dist.is_initialized() else None


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_per_device(command: list[str], nprocs: int, timeout: Optional[float] = None,
                     stdout=None) -> int:
    """Run ``python *command`` (e.g. ``["-m", module, *argv]``) in ``nprocs``
    processes as ranks 0 .. nprocs − 1 of one group on localhost, and wait
    for them.

    Each gets the launcher's variables (``LOCAL_RANK`` picks its GPU) and
    writes its output to ``stdout``: a file, a list of one file per rank, or
    None for this process's. If a rank fails, or ``timeout`` seconds pass,
    the others are killed. Returns 0, or the first nonzero exit code (124 on
    the timeout)."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    outs = stdout if isinstance(stdout, (list, tuple)) else [stdout] * nprocs
    procs = [
        subprocess.Popen([sys.executable, *command], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                         stdout=outs[r], stderr=None if outs[r] is None else subprocess.STDOUT)
        for r in range(nprocs)
    ]
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed or (deadline is not None and time.monotonic() > deadline):
                rc = failed[0] if failed else 124
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc or next((p.returncode for p in procs if p.returncode), 0)


def visible_devices(device: torch.device | str) -> int:
    """The GPUs a ``cuda`` device without an index may spread over (those
    of ``CUDA_VISIBLE_DEVICES``); one for any other device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.cuda.device_count()
    return 1


def join_or_spawn(module: str, argv: Optional[list[str]], device: torch.device | str,
                  nprocs: Optional[int] = None) -> tuple[Optional[int], Optional[Mesh]]:
    """How an entry point runs over every visible GPU, as the JAX entry
    points run over every visible device:

    - under a launcher: join the group → (None, the mesh over the ranks);
    - else with more than one visible GPU: run ``module`` with ``argv``
      (default ``sys.argv[1:]``) in one worker per GPU, or in ``nprocs``
      workers where given → (their exit code, None);
    - else → (None, None): one device, today's path."""
    if launched():
        init_distributed(device=device)
        return None, data_parallel_mesh(device)
    n = visible_devices(device) if nprocs is None else nprocs
    if n > 1:
        argv = sys.argv[1:] if argv is None else list(argv)
        return spawn_per_device(["-m", module, *argv], n), None
    return None, None
