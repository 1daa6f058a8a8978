"""Training engine: train step, epoch loop, checkpoint and resume.

Counterpart of ``im2im_uq_tpu/training/train.py``, with its control flow and
its accounting:

- the train step runs the model in train mode (BatchNorm on batch
  statistics, updating its running statistics), takes the per-example loss
  of the head, its masked mean over the real examples of the batch
  (``Σ loss·mask / max(Σ mask, 1)``), and one ``torch.optim.Adam(lr)`` step
  with optax's defaults: β = (0.9, 0.999), eps = 1e-8 outside the square
  root;
- epochs shuffle with ``np.random.RandomState(seed + 1000·epoch + 1)`` and
  pad the last batch by wrapping real examples (``pad_mode="wrap"``);
- the epoch's ``train_loss`` is the sum of the batch means over the number
  of real examples, and ``eval_net`` reports the same quotient;
- validation every ``validate_every`` epochs (then ``validation_hook``),
  checkpoints every ``checkpoint_every``, the resume scan with its
  short-circuit when the final checkpoint exists, and ``graceful_shutdown``
  (SIGTERM/SIGINT → checkpoint at the end of the epoch →
  :class:`PreemptionInterrupt`).

Data parallelism (``mesh``, a ``parallel.mesh.Mesh`` of several ranks, one
process per GPU) computes what the JAX mesh step computes, the program of
the global batch: the batch size is rounded up to a multiple of the ranks
(``mesh_batch_size``), every rank takes its slice of each batch,
BatchNorm normalises over the global batch (``models/unet.global_batch``),
the loss is the local masked sum over the **global** mask count, and the
gradients are summed over the ranks after the backward, in one collective
per dtype, so that they never interleave with the BatchNorm collectives.
Plain DDP would average per-rank means, which is wrong where the ranks hold
different numbers of real examples (a rounded batch, the wrapped last
batch). Adam's state stays replicated: every rank applies the same sums.
Rank 0 alone writes checkpoints and the logger's records, with a barrier
after each epoch's writes; every rank loads a checkpoint to resume, and a
stop signal on any rank stops every rank at the end of the epoch.

The on-device input transforms: ``preprocess`` (x → x) or
``preprocess_pair`` ((x, y) → (x, y)) run inside the train and eval steps,
on the model's device, before the forward; the loader then ships raw items
(FastMRI's masked k-space, ``data/fastmri.FastMRIDataset.device_preprocess``;
TEMCA's uint8 patches, ``data/temca.TEMCADataset.device_preprocess_pair``).
``preprocess`` gets x in the loader's layout and dtype (k-space
(B, H, W, 2), whose last dim is the complex pair, not a channel);
``preprocess_pair`` gets x and y NCHW in their own dtype (uint8 goes to the
card as uint8). A raw batch on another device than the model's raises; it
is never transformed on the host. Over a mesh each rank transforms its own
slice of the raw batch.

``loader_procs: N`` fetches the training items in N worker processes
(``data/core.ProcessPoolFetcher``, one pool for the whole run) and gives the
threaded loader's batches. ``async_checkpoint: true`` writes each epoch's
checkpoint on a background thread from a CPU copy taken at save time
(``training/checkpoint.py``); ``train_net`` waits for it before it
returns.

``input_pipeline: grain`` (any other value is the threaded loader, as in
the JAX package) takes each epoch's batches from
``data/grain_pipeline.CheckpointableBatchIterator`` (grain's order, seed
``seed + 1000·epoch + 1``, a map-style dataset only; ``loader_procs`` is
ignored). With it, ``checkpoint_every_steps: N`` writes the mid-epoch
checkpoint every N steps of an epoch, and ``graceful_shutdown`` saves the
same file at the next step and raises :class:`PreemptionInterrupt`; a resume
continues inside the epoch from that file when it is ahead of the newest
epoch checkpoint, and the file is removed when its epoch completes. The
epoch's loss is then summed one step at a time in float64, so a resumed run
reports the uninterrupted run's ``train_loss`` bit for bit.

:func:`make_train_multistep` runs N steps of the train step on one batch
that stays on the device, in one host dispatch: a CUDA graph on the card.

Unlike the JAX engine, which returns new arrays, training updates the
caller's model in place: the returned ``UQState`` holds the same module.
Not ported, and refused when asked for: ``precompile_calibration``, and
``make_train_multistep`` over a mesh of several ranks.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from im2im_uq_tpu_torch.data.core import ProcessPoolFetcher, iterate_batches
from im2im_uq_tpu_torch.data.grain_pipeline import CheckpointableBatchIterator
from im2im_uq_tpu_torch.models.assembly import UQModel, UQState, nchw_from_nhwc
from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
from im2im_uq_tpu_torch.models.unet import global_batch
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.parallel.mesh import Mesh
from im2im_uq_tpu_torch.training import checkpoint as ckpt
from im2im_uq_tpu_torch.utils.logging import MetricsLogger

__all__ = [
    "PreemptionInterrupt",
    "eval_net",
    "make_eval_loss_step",
    "make_train_multistep",
    "make_train_step",
    "put_batch",
    "train_net",
]

# The JAX package's top-level parameter names, which the gradient-norm log
# keys carry (grad_norm/trunk, grad_norm/head).
_NORM_KEYS = {"baseModel": "trunk", "last_layer": "head"}


class PreemptionInterrupt(RuntimeError):
    """Raised after a graceful signal-triggered checkpoint save.

    ``graceful_shutdown: true`` and a ``checkpoint_dir`` turn SIGTERM/SIGINT
    into a save and this exception: at the next step with
    ``input_pipeline: grain`` (the mid-epoch checkpoint), at the end of the
    current epoch otherwise; resume with ``load_from_checkpoint: true``.
    The saved path is carried on ``.checkpoint_path``.
    """

    def __init__(self, checkpoint_path: str):
        super().__init__(
            f"training interrupted by signal; state saved to {checkpoint_path} "
            "(resume with load_from_checkpoint: true)"
        )
        self.checkpoint_path = checkpoint_path


def _masked_mean(per_example: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """√(Σ ‖g‖²) over tensors, as ``optax.global_norm``."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def put_batch(x: np.ndarray, y: np.ndarray, mask: np.ndarray, device: torch.device,
              raw_input: bool = False):
    """NHWC numpy batch → NCHW tensors and the (B,) f32 mask on ``device``.

    ``raw_input``: x is the raw input of a ``preprocess`` hook and goes to
    the device as the loader made it, in its layout and dtype."""
    x = (torch.from_numpy(np.ascontiguousarray(x)).to(device) if raw_input
         else nchw_from_nhwc(x, device))
    return (x, nchw_from_nhwc(y, device),
            torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(device))


def _input_transform(preprocess: Optional[Callable], preprocess_pair: Optional[Callable],
                     model: UQModel) -> Callable:
    """(x, y) → the model's (x, y): the hook, run on the model's device."""
    if preprocess is not None and preprocess_pair is not None:
        raise ValueError("pass preprocess OR preprocess_pair, not both")

    def transform(x: torch.Tensor, y: torch.Tensor):
        if preprocess is None and preprocess_pair is None:
            return x, y
        device = next(model.parameters()).device
        if x.device != device or y.device != device:
            raise ValueError(
                f"the raw batch is on {x.device}, the model on {device}: the on-device "
                "transform runs on the model's device"
            )
        if preprocess is not None:
            return preprocess(x), y
        return preprocess_pair(x, y)

    return transform


def _global_masked_mean(per_example: torch.Tensor, mask: torch.Tensor,
                        mesh: Optional[Mesh]) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's Σ loss·mask over the global max(Σ mask, 1), the global
    Σ mask): summed over the ranks, the global batch's masked mean."""
    if not mesh_lib.spans(mesh):
        return _masked_mean(per_example, mask), mask.sum()
    count = mesh.all_reduce(mask.sum())
    return (per_example * mask).sum() / torch.clamp(count, min=1.0), count


def make_train_step(
    model: UQModel,
    loss_pe_fn: Callable,
    hyper: dict,
    optimizer: torch.optim.Optimizer,
    mesh: Optional[Mesh] = None,
    preprocess: Optional[Callable] = None,
    preprocess_pair: Optional[Callable] = None,
):
    """Build the train step: (x, y, mask) → loss, or (loss, grad norms) when
    ``hyper["watch_gradients"]`` is set. It updates ``model`` and
    ``optimizer`` in place; the loss is a detached device scalar and the
    gradients of the step stay on the parameters' ``.grad``.

    ``preprocess`` maps the raw batch input to the model input, and
    ``preprocess_pair`` the raw (x, y) to the model's (x, y), inside the
    step, before the forward (module docstring); pass one or neither.

    The step puts the model in train mode itself: ``UQState.forward`` (used
    by validation and by validation hooks) leaves it in eval mode, and a
    step in eval mode would normalise with the running statistics.

    Over a ``mesh`` of several ranks the step takes this rank's slice of
    the global batch and computes the global batch's step (module
    docstring); the loss it returns, the gradients and the norms are the
    global ones, the same on every rank.
    """
    watch = bool(hyper.get("watch_gradients"))
    multi = mesh_lib.spans(mesh)
    transform = _input_transform(preprocess, preprocess_pair, model)

    def train_step(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
        x, y = transform(x, y)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with global_batch(mesh):
            loss, _ = _global_masked_mean(loss_pe_fn(model(x), y, hyper), mask, mesh)
            loss.backward()
        if multi:
            mesh_lib.reduce_gradients(model.parameters(), mesh)
            loss = mesh.all_reduce(loss.detach())
        norms = None
        if watch:
            # gradient observability (counterpart of wandb.watch): global
            # and per-top-level-module L2 norms of this step's gradients
            groups: dict[str, list[torch.Tensor]] = {}
            for name, p in model.named_parameters():
                if p.grad is not None:
                    groups.setdefault(_NORM_KEYS.get(name.split(".")[0], name), []).append(p.grad)
            norms = {"grad_norm/global": _global_norm([g for v in groups.values() for g in v])}
            for key, grads in groups.items():
                norms[f"grad_norm/{key}"] = _global_norm(grads)
        optimizer.step()
        loss = loss.detach()
        return (loss, norms) if watch else loss

    return train_step


def _state_tensors(model: UQModel, optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every parameter, buffer and optimizer state tensor."""
    return [*model.parameters(), *model.buffers(),
            *(v for st in optimizer.state.values() for v in st.values()
              if isinstance(v, torch.Tensor))]


def make_train_multistep(
    model: UQModel,
    loss_pe_fn: Callable,
    hyper: dict,
    optimizer: torch.optim.Optimizer,
    num_steps: int,
    mesh: Optional[Mesh] = None,
    preprocess: Optional[Callable] = None,
    preprocess_pair: Optional[Callable] = None,
):
    """``num_steps`` train steps on one batch that stays on the device, in one
    host dispatch: (x, y, mask) → the last step's loss (float32). The
    counterpart of the JAX ``make_train_multistep`` (its ``fori_loop`` over
    ``make_train_step``'s body); each step is :func:`make_train_step`'s
    (without ``watch_gradients``' norms, as the JAX loop drops them).

    On the card, the first call captures the ``num_steps`` steps in one
    ``torch.cuda.CUDAGraph`` over static copies of x, y and mask, then every
    call copies its batch in and replays the graph once: one host dispatch
    for the N steps, whose launches are N times the step's. Before the
    capture one warm-up step runs on a side stream (it allocates the
    optimizer's state and the libraries' workspaces); the parameters,
    buffers and optimizer state are then put back as they were, so the
    warm-up does not advance the model. The optimizer must be built with
    ``capturable=True`` (Adam then keeps its step count and bias correction
    on the device); a graph that does not capture raises. Every later call
    needs x, y and mask of the first call's shapes and dtypes.

    On the CPU: a plain loop of the same step. Over a mesh of several ranks
    (NCCL inside a graph) it is not yet ported and raises.
    """
    if mesh_lib.spans(mesh):
        raise NotImplementedError(
            "make_train_multistep over a mesh of several ranks is not yet ported"
        )
    if num_steps < 1:
        raise ValueError("num_steps must be at least 1")
    hyper = {k: v for k, v in hyper.items() if k != "watch_gradients"}
    step = make_train_step(model, loss_pe_fn, hyper, optimizer, None, preprocess,
                           preprocess_pair)
    device = next(model.parameters()).device

    if device.type != "cuda":
        def loop(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
            loss = None
            for _ in range(num_steps):
                loss = step(x, y, mask)
            return loss.float()

        return loop

    if not all(g.get("capturable", False) for g in optimizer.param_groups):
        raise ValueError("make_train_multistep on CUDA needs an optimizer built with "
                         "capturable=True")
    graph: dict = {}

    def capture(x, y, mask):
        static = [t.detach().clone() for t in (x, y, mask)]
        saved = {id(t): t.detach().clone() for t in _state_tensors(model, optimizer)}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t in _state_tensors(model, optimizer):
                if id(t) in saved:
                    t.copy_(saved[id(t)])
                else:
                    t.zero_()  # state the warm-up created: a fresh Adam's
        optimizer.zero_grad(set_to_none=True)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(num_steps):
                loss = step(*static)
        graph.update(graph=g, static=static, loss=loss)

    def multistep(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not graph:
            capture(x, y, mask)
        for dst, src in zip(graph["static"], (x, y, mask)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"the graph was captured for {tuple(dst.shape)} {dst.dtype}, "
                                 f"not {tuple(src.shape)} {src.dtype}")
            dst.copy_(src)
        graph["graph"].replay()
        return graph["loss"].float().clone()

    return multistep


def make_eval_loss_step(model: UQModel, loss_pe_fn: Callable, hyper: dict,
                        mesh: Optional[Mesh] = None, preprocess: Optional[Callable] = None,
                        preprocess_pair: Optional[Callable] = None):
    """Eval-mode loss: (x, y, mask) → (masked mean, number of real examples),
    of the global batch over a ``mesh`` (this rank's slice in); the hooks as
    :func:`make_train_step`'s."""
    transform = _input_transform(preprocess, preprocess_pair, model)

    def eval_step(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
        model.eval()
        with torch.inference_mode():
            x, y = transform(x, y)
            out = model(x)
            loss, count = _global_masked_mean(loss_pe_fn(out, y, hyper), mask, mesh)
            return (mesh.all_reduce(loss) if mesh_lib.spans(mesh) else loss), count

    return eval_step


def eval_net(
    uq_state: UQState, dataset, batch_size: int, mesh: Optional[Mesh] = None, step=None,
    raw_input: bool = False,
) -> float:
    """Mean validation loss: sum(batch mean losses) / number of examples.

    Pass a prebuilt ``step`` to reuse one across epochs; over a ``mesh`` it
    must be one built for it. ``raw_input``: the step was built with a
    ``preprocess`` hook, whose raw input keeps the loader's layout
    (:func:`put_batch`).
    """
    mesh_lib.check_mesh(mesh)
    if step is None:
        loss_pe = head_loss_pe_fn(uq_state.uncertainty_type)
        step = make_eval_loss_step(uq_state.model, loss_pe, uq_state.params, mesh)
    device = uq_state.device
    total, count = 0.0, 0
    batch_size = mesh_lib.mesh_batch_size(batch_size, mesh)
    for x, y, mask in iterate_batches(dataset, batch_size, shuffle=False):
        loss, n = step(*put_batch(*mesh_lib.put_batch(mesh, x, y, mask), device, raw_input))
        total += float(loss)
        count += int(n)
    return total / count if count else 0.0


def _refuse_unported(config: dict, mesh) -> None:
    mesh_lib.check_mesh(mesh)
    if config.get("precompile_calibration"):
        raise NotImplementedError("precompile_calibration is not yet ported")


def _map_style(dataset) -> bool:
    return hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__")


def _fetcher(config: dict, train_dataset) -> Optional[ProcessPoolFetcher]:
    """``loader_procs``: one pool of worker processes for the whole run
    (not under ``input_pipeline: grain``, as in the JAX package)."""
    if not config.get("loader_procs") or config.get("input_pipeline") == "grain":
        return None
    if not _map_style(train_dataset):
        raise ValueError(
            "loader_procs requires a map-style dataset (__len__ + "
            "__getitem__); iterable streams (e.g. TEMCA) fetch "
            "sequentially on the producer thread."
        )
    return ProcessPoolFetcher(train_dataset, int(config["loader_procs"]))


def _fold_losses(carried: float, losses: list[torch.Tensor]) -> float:
    """``carried`` plus each step's loss, one at a time in float64: the same
    sum wherever an epoch was checkpointed and resumed."""
    for v in (torch.stack(losses).tolist() if losses else []):
        carried += v
    return carried


def _optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Steps taken so far, from Adam's per-parameter state (0 when fresh)."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def train_net(
    uq_state: UQState,
    train_dataset,
    val_dataset,
    mesh,
    epochs: int,
    batch_size: int,
    lr: float,
    load_from_checkpoint: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    validate_every: int = 10,
    config: Optional[dict] = None,
    logger: Optional[MetricsLogger] = None,
    seed: int = 0,
    validation_hook: Optional[Callable] = None,
    preprocess: Optional[Callable] = None,
    preprocess_pair: Optional[Callable] = None,
) -> UQState:
    """Train ``uq_state.model`` in place; returns the UQState with λ̂ as
    restored (or as given). ``mesh``: None (one device) or a
    ``parallel.mesh.Mesh`` whose ranks train together (module docstring);
    the model must already sit on this rank's device. ``preprocess`` /
    ``preprocess_pair``: the on-device input transform of the train and
    validation steps (module docstring)."""
    config = dict(config or uq_state.params)
    _refuse_unported(config, mesh)
    use_grain = config.get("input_pipeline", "threaded") == "grain"
    if use_grain and not _map_style(train_dataset):
        raise ValueError(
            "input_pipeline: grain requires a map-style dataset (__len__ + "
            "__getitem__); iterable streams (e.g. TEMCA) use the default "
            "threaded pipeline."
        )
    if mesh is not None and not mesh.is_main:
        logger = None  # rank 0 writes the records
    logger = logger or MetricsLogger(None)
    model = uq_state.model
    loss_pe = head_loss_pe_fn(uq_state.uncertainty_type)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    starting_epoch = 0
    lhat = uq_state.lhat
    if load_from_checkpoint and checkpoint_dir:
        path, start = ckpt.find_resume_checkpoint(checkpoint_dir, epochs, config)
        if path is not None:
            lhat, _ = ckpt.restore_checkpoint(path, model, optimizer)
            starting_epoch = start
            print(f"Resumed from checkpoint {path} (epoch {start}).")
            if start >= epochs:
                return uq_state.replace(lhat=lhat)

    # the mid-epoch checkpoint (grain only): resume inside a preempted epoch
    # when it is further along than the newest epoch checkpoint
    resume = None
    if load_from_checkpoint and checkpoint_dir and use_grain:
        mp = ckpt.midepoch_checkpoint_path(checkpoint_dir, config)
        if os.path.exists(mp):
            resume = ckpt.restore_midepoch_checkpoint(mp, model, optimizer,
                                                      (starting_epoch, epochs))
            if resume is not None:
                lhat, starting_epoch = resume[0], resume[1]
                print(f"Resumed mid-epoch from {mp} "
                      f"(epoch {starting_epoch}, step {resume[3].get('steps', '?')}).")

    # every rank starts from rank 0's weights and statistics
    mesh_lib.replicate_tree(mesh, model)
    batch_size = mesh_lib.mesh_batch_size(batch_size, mesh)
    hooks = {"preprocess": preprocess, "preprocess_pair": preprocess_pair}
    train_step = make_train_step(model, loss_pe, config, optimizer, mesh, **hooks)
    eval_step = make_eval_loss_step(model, loss_pe, config, mesh, **hooks)
    fetcher = _fetcher(config, train_dataset)

    # graceful_shutdown: SIGTERM/SIGINT request a checkpoint at the end of
    # the current epoch instead of killing the run. The first signal
    # restores the previous handlers, so a second one aborts at once.
    stop_signal = {"signum": None}
    restore_handlers: list = []
    if config.get("graceful_shutdown") and checkpoint_dir:

        def _on_signal(signum, frame):
            stop_signal["signum"] = signum
            for s, old in restore_handlers:
                signal.signal(s, old)

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                restore_handlers.append((s, signal.signal(s, _on_signal)))
        except ValueError:
            # signal handlers are main-thread-only; run unguarded elsewhere
            restore_handlers = []

    try:
        lhat = _run_epochs(
            uq_state, model, optimizer, lhat, train_dataset, val_dataset,
            starting_epoch, epochs, batch_size, seed, checkpoint_dir,
            checkpoint_every, validate_every, config, logger, validation_hook,
            train_step, eval_step, stop_signal, mesh, fetcher, preprocess is not None,
            resume, bool(restore_handlers),
        )
    finally:
        for s, old in restore_handlers:
            signal.signal(s, old)
        if fetcher is not None:
            fetcher.close()
        # also on the preemption path: the last background save commits
        ckpt.wait_for_async_saves()
    return uq_state.replace(lhat=lhat)


def _run_epochs(
    uq_state, model, optimizer, lhat, train_dataset, val_dataset,
    starting_epoch, epochs, batch_size, seed, checkpoint_dir,
    checkpoint_every, validate_every, config, logger, validation_hook,
    train_step, eval_step, stop_signal, mesh, fetcher, raw_input, resume, guarded,
):
    """The epoch loop of :func:`train_net`; returns λ̂. ``resume``: what
    ``restore_midepoch_checkpoint`` gave, or None; ``guarded``: the stop
    signal's handlers are installed."""
    device = uq_state.device
    writes = mesh is None or mesh.is_main
    async_save = bool(config.get("async_checkpoint", False))
    use_grain = config.get("input_pipeline", "threaded") == "grain"
    ckpt_steps = int(config.get("checkpoint_every_steps") or 0)
    global_step = _optimizer_steps(optimizer)
    for epoch in range(starting_epoch, epochs):
        epoch_seed = seed + 1000 * epoch + 1
        carried_loss, num_examples, steps_in_epoch = 0.0, 0, 0
        if use_grain:
            batches = CheckpointableBatchIterator(train_dataset, batch_size, shuffle=True,
                                                  seed=epoch_seed, pad_mode="wrap")
            if resume is not None:
                batches.set_state(resume[2])
                carried_loss = float(resume[3].get("sum_loss", 0.0))
                num_examples = int(resume[3].get("num_examples", 0))
                steps_in_epoch = int(resume[3].get("steps", 0))
        else:
            batches = iterate_batches(
                train_dataset, batch_size, shuffle=True,
                rng=np.random.RandomState(epoch_seed), pad_mode="wrap", fetcher=fetcher,
            )
        resume = None
        losses, grad_norms = [], None
        # where the epoch's wall time goes: the step call returns before the
        # device finishes, so queued work drains at the epoch-end loss fetch
        t_data = t_dispatch = 0.0
        epoch_t0 = time.perf_counter()
        batch_iter = iter(batches)
        while True:
            t0 = time.perf_counter()
            item = next(batch_iter, None)
            t_data += time.perf_counter() - t0
            if item is None:
                break
            x, y, mask = item
            t0 = time.perf_counter()
            out = train_step(*put_batch(*mesh_lib.put_batch(mesh, x, y, mask), device,
                                        raw_input))
            t_dispatch += time.perf_counter() - t0
            if isinstance(out, tuple):
                out, grad_norms = out  # the last step's norms are logged
            losses.append(out)
            num_examples += int(mask.sum())
            global_step += 1
            steps_in_epoch += 1
            if use_grain and checkpoint_dir:
                stop = stop_signal["signum"] is not None
                if guarded and mesh_lib.spans(mesh):
                    stop = mesh.agree(stop)  # a signal to any rank stops them all
                if stop or (ckpt_steps and steps_in_epoch % ckpt_steps == 0):
                    # one save serves the periodic checkpoint and the stop
                    carried_loss, losses = _fold_losses(carried_loss, losses), []
                    mp = ckpt.midepoch_checkpoint_path(checkpoint_dir, config)
                    if writes:
                        ckpt.save_midepoch_checkpoint(
                            mp, model, optimizer, lhat, epoch, batches.get_state(),
                            {"sum_loss": carried_loss, "num_examples": num_examples,
                             "steps": steps_in_epoch})
                    if mesh_lib.spans(mesh):
                        mesh.barrier()
                    if stop:
                        raise PreemptionInterrupt(mp)
        if use_grain and checkpoint_dir and writes:
            # the epoch completed: drop the mid-epoch file (gated like the
            # save, which the stop writes without checkpoint_every_steps)
            mp = ckpt.midepoch_checkpoint_path(checkpoint_dir, config)
            if os.path.exists(mp):
                os.remove(mp)
        t0 = time.perf_counter()
        epoch_loss = _fold_losses(carried_loss, losses)
        t_sync = time.perf_counter() - t0
        logger.log(
            {"epoch": epoch, "iter": global_step, "train_loss": epoch_loss / max(num_examples, 1)}
        )
        if grad_norms is not None:
            logger.log(
                {"epoch": epoch, "iter": global_step,
                 **{k: float(v) for k, v in grad_norms.items()}}
            )

        current = uq_state.replace(lhat=lhat)
        t_val = 0.0
        if epoch % validate_every == 0:
            t0 = time.perf_counter()
            val_loss = eval_net(current, val_dataset, batch_size, mesh, step=eval_step,
                                raw_input=raw_input)
            t_val = time.perf_counter() - t0
            logger.log({"epoch": epoch, "iter": global_step, "val_loss": val_loss})
            print(f"Val loss: {val_loss}")
            if validation_hook is not None:
                validation_hook(current, epoch, global_step)

        t0 = time.perf_counter()
        if (epoch + 1) % checkpoint_every == 0 and checkpoint_dir and writes:
            path = ckpt.checkpoint_path(checkpoint_dir, epoch + 1, config)
            ckpt.save_checkpoint(path, model, optimizer, lhat, epoch + 1, async_save=async_save)
            print(f"Checkpoint {epoch + 1} saved!")
        t_ckpt = time.perf_counter() - t0

        logger.log({
            "epoch": epoch, "iter": global_step,
            "time/epoch_s": round(time.perf_counter() - epoch_t0, 3),
            "time/data_wait_s": round(t_data, 3),
            "time/step_dispatch_s": round(t_dispatch, 3),
            "time/device_drain_s": round(t_sync, 3),
            "time/val_s": round(t_val, 3),
            "time/checkpoint_s": round(t_ckpt, 3),
        })

        stop = stop_signal["signum"] is not None
        if mesh_lib.spans(mesh):
            # a signal to any rank stops them all at this epoch's end
            stop = mesh.agree(stop)
        if stop and checkpoint_dir:
            # graceful preemption: the epoch is finished; persist it as a
            # whole-epoch checkpoint if the periodic save did not, and stop
            path = ckpt.checkpoint_path(checkpoint_dir, epoch + 1, config)
            if (epoch + 1) % checkpoint_every != 0 and writes:
                ckpt.save_checkpoint(path, model, optimizer, lhat, epoch + 1)
            if mesh_lib.spans(mesh):
                mesh.barrier()
            raise PreemptionInterrupt(path)
        if mesh_lib.spans(mesh):
            mesh.barrier()  # rank 0's checkpoint and records are written
    return lhat
