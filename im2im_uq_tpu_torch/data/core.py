"""Dataset protocol, splitting, and the host→device batch pipeline.

The reference feeds torch DataLoaders with num_workers=0 — single-threaded,
per-example host loops (reference: core/scripts/train.py:104-110). Here the
input pipeline is built to keep a TPU fed: threaded item fetch, pinned
numpy staging, fixed batch shapes (final batch zero-padded with an explicit
mask so every step hits the same compiled program), and device placement
with batch-axis sharding over the mesh.

Datasets are simple objects with ``__len__`` and ``__getitem__ -> (x, y)``
numpy arrays shaped (H, W, C) — the NHWC counterpart of the reference's
CxHxW tensor pairs (SURVEY.md §1 data layer contract).

The port's copy of ``im2im_uq_tpu/data/core.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import concurrent.futures as _futures
import threading
import time
from queue import Full, Queue
from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = [
    "Subset",
    "random_split",
    "split_lengths",
    "Batch",
    "iterate_batches",
    "stack_examples",
    "pad_batch",
    "ProcessPoolFetcher",
]


class Subset:
    """View of a dataset at fixed indices (torch.utils.data.Subset analogue)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]

    def __getattr__(self, name):
        # forward metadata attributes (norm_params, cache_path, ...) to the
        # base; never forward 'dataset' itself or dunder/private probes —
        # pickle/deepcopy query them on instances whose __dict__ is not yet
        # populated and unconditional forwarding recurses forever
        if name == "dataset" or name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.dataset, name)


def split_lengths(n: int, percentages: Sequence[float]) -> list[int]:
    """Rounded split sizes with the remainder absorbed by the last split.

    Same arithmetic as the router (reference: core/scripts/router.py:101-103):
    round(n * p) per split, last split = n − sum(others).
    """
    lengths = np.round(n * np.asarray(percentages)).astype(int)
    lengths[-1] = n - (lengths.sum() - lengths[-1])
    return lengths.tolist()


def random_split(dataset, lengths: Sequence[int], rng: np.random.RandomState):
    """Random partition into consecutive chunks of a permutation.

    Counterpart of torch random_split used by the router (router.py:104).
    """
    if sum(lengths) != len(dataset):
        raise ValueError(f"split lengths {lengths} do not sum to {len(dataset)}")
    perm = rng.permutation(len(dataset))
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs : ofs + ln]))
        ofs += ln
    return out


class Batch(tuple):
    """(x, y, mask) — mask is 1.0 for real examples, 0.0 for padding."""

    @property
    def x(self):
        return self[0]

    @property
    def y(self):
        return self[1]

    @property
    def mask(self):
        return self[2]


def stack_examples(examples) -> tuple[np.ndarray, np.ndarray]:
    xs, ys = zip(*examples)
    return np.stack(xs), np.stack(ys)


def pad_batch(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    pad_mode: str = "zeros",
    pad_final: bool = True,
) -> Batch:
    """Pad a ragged batch to ``batch_size`` with a validity mask.

    The single source of the fixed-shape batch contract, shared by the
    threaded and grain pipelines: ``zeros`` pads with zero examples (fine
    for eval, where BatchNorm uses running stats), ``wrap`` repeats real
    examples (keeps train-mode BatchNorm statistics on real data); the mask
    excludes padding from the loss either way. ``pad_final=False`` emits
    the ragged batch unchanged (all-ones mask).
    """
    mask = np.ones((x.shape[0],), dtype=np.float32)
    if pad_final and x.shape[0] < batch_size:
        pad = batch_size - x.shape[0]
        if pad_mode == "wrap":
            sel = np.arange(pad) % x.shape[0]
            x = np.concatenate([x, x[sel]])
            y = np.concatenate([y, y[sel]])
        else:
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.zeros((pad, *y.shape[1:]), y.dtype)])
        mask = np.concatenate([mask, np.zeros((pad,), np.float32)])
    return Batch((x, y, mask))


def _fetch(dataset, idx, pool: Optional[_futures.ThreadPoolExecutor]):
    if pool is None:
        return [dataset[i] for i in idx]
    return list(pool.map(dataset.__getitem__, idx))


_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    # group-delivered SIGTERM/SIGINT (Ctrl-C, scheduler preemption) must not
    # kill the workers: graceful_shutdown needs the pool alive to finish the
    # epoch and checkpoint; the parent terminates the pool on close()
    import signal

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    _WORKER_DATASET = dataset


def _worker_get(i):
    return _WORKER_DATASET[i]


class ProcessPoolFetcher:
    """Fetch dataset items in worker PROCESSES — the GIL/h5py-lock escape.

    Threads cannot parallelize the FastMRI host transform (h5py's global
    library lock + GIL-bound numpy physics, see iterate_batches); separate
    processes can. The dataset is pickled once per worker at pool start
    (FastMRIDataset ships cleanly); per-item results come back through the
    pickle channel. Use as the ``fetcher`` argument of iterate_batches and
    keep ONE fetcher alive for the whole run (spawn startup costs seconds —
    per-epoch pools would pay it every epoch). Counterpart of torch
    DataLoader(num_workers=N); the reference hard-codes num_workers=0
    (reference train.py:104-110).
    """

    def __init__(self, dataset, num_procs: int = 4, start_method: str = "spawn"):
        import multiprocessing as mp

        # spawn, not fork: the parent usually has live JAX/XLA threads,
        # which a forked child inherits in a broken state
        ctx = mp.get_context(start_method)
        self._pool = ctx.Pool(num_procs, initializer=_worker_init, initargs=(dataset,))
        self.num_procs = num_procs

    def fetch(self, indices) -> list:
        return self._pool.map(_worker_get, list(indices))

    def close(self) -> None:
        # Workers ignore SIGTERM (see _worker_init), and that breaks
        # Pool.terminate()'s contract: _terminate_pool abandons the inqueue
        # read lock (_help_stuff_finish acquires and never releases it) and
        # then relies on SIGTERM to kill any worker that can no longer read
        # its exit sentinel — with SIGTERM ignored, its final unbounded
        # p.join() deadlocks. Seen live under CPU throttle (round 4): one
        # worker exited on its sentinel, the other futex-blocked on the
        # abandoned rlock forever, parent stuck in waitpid. So shut down
        # WITHOUT Pool.terminate(): graceful close() (one sentinel per
        # worker, no lock games), bounded join, SIGKILL escalation for a
        # worker still alive after the deadline (stuck __getitem__ — hung
        # NFS/HDF5 read), then reap the pool machinery.
        procs = list(getattr(self._pool, "_pool", []))
        self._pool.close()
        deadline = time.monotonic() + 10.0
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iterate_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    rng: Optional[np.random.RandomState] = None,
    pad_final: bool = True,
    pad_mode: str = "zeros",
    num_threads: int = 0,
    prefetch: int = 2,
    fetcher: Optional["ProcessPoolFetcher"] = None,
) -> Iterator[Batch]:
    """Yield fixed-shape (x, y, mask) numpy batches with prefetch.

    The final partial batch is padded to ``batch_size`` (mask marks padding)
    so jit sees one shape; ``pad_mode='zeros'`` pads with zeros (fine for
    eval, where BatchNorm uses running stats), ``pad_mode='wrap'`` repeats
    real examples (keeps train-mode BatchNorm statistics on real data; the
    mask still excludes padding from the loss). Set ``pad_final=False`` to
    emit the ragged tail instead. Batches are fetched ``prefetch`` ahead on
    a background producer thread so host work overlaps device compute.

    ``num_threads`` defaults to 0 (items fetched sequentially on the
    producer thread): measured on the FastMRI HDF5 path, a thread pool is
    2-4x SLOWER than sequential fetch — h5py serializes every access
    behind a global library lock and the numpy transform is GIL-bound, so
    threads only add contention (75 imgs/s sequential vs 17-25 with 8
    threads at 320² geometry, benchmarks/bench_input_pipeline.py). Opt in
    for datasets whose __getitem__ genuinely releases the GIL. For
    throughput beyond one core, use raw k-space mode + the on-device
    transform (245 imgs/s host-side) — the production path.
    """
    map_style = hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__")
    if map_style:
        n = len(dataset)
        order = np.arange(n)
        if shuffle:
            (rng or np.random).shuffle(order)
    else:
        # iterable dataset (e.g. TEMCA's buffered patch stream): rewind if
        # resettable (the reference calls dataset.reset() before sweeps,
        # eval.py:87-90) and chunk the stream; shuffling is the stream's job.
        if hasattr(dataset, "reset"):
            dataset.reset()

    pool = _futures.ThreadPoolExecutor(num_threads) if num_threads > 0 else None
    q: Queue = Queue(maxsize=max(prefetch, 1))
    _SENTINEL = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that aborts when the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def _chunks():
        if map_style:
            for start in range(0, n, batch_size):
                idx = order[start : start + batch_size]
                if fetcher is not None:
                    yield fetcher.fetch(idx)
                else:
                    yield _fetch(dataset, idx, pool)
        else:
            chunk = []
            for example in dataset:
                chunk.append(example)
                if len(chunk) == batch_size:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

    def producer():
        try:
            for examples in _chunks():
                x, y = stack_examples(examples)
                if not _put(pad_batch(x, y, batch_size, pad_mode, pad_final)):
                    return
        except BaseException as e:  # surface worker errors to the consumer
            _put(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()  # unblocks a producer parked on the bounded queue
        t.join(timeout=2.0)
        if pool is not None:
            pool.shutdown(wait=False)
