"""The grain input pipeline's batches and mid-epoch iterator state, without grain.

Counterpart of ``im2im_uq_tpu/data/grain_pipeline.py`` (``grain_batches``,
``CheckpointableBatchIterator``, ``make_grain_dataset``). That module hands
the dataset to grain (``MapDataset.source(ds)[shard::count].seed(s).shuffle()
.repeat(e).batch(b)``); the port rebuilds the same index order in numpy, so
that a run resumed mid-epoch reads the batches the JAX pipeline would read,
and imports no grain (whose import loads JAX).

The order, as grain computes it:

- the shard is sliced first, ``dataset[shard_index::shard_count]``;
- ``seed(s).shuffle()`` shuffles with the seed
  ``SeedSequence([s, 1]).generate_state(1, uint32)[0]`` (grain's default
  seed of a transformation one level below the seeded node);
- position ``i`` of epoch ``e`` (of ``repeat(num_epochs)``) reads the shard's
  element ``index_shuffle(i, n - 1, (seed + e) mod 2³², rounds=4)``: grain's
  C++ ``index_shuffle``, which :func:`grain_order` reproduces — a
  Simon-cipher Feistel network over the smallest even bit width ≥ 16 that
  holds ``n - 1``, round keys from ``std::seed_seq({seed})``, cycle-walking
  until the value lands in ``[0, n)``;
- batches of ``batch_size`` run over the repeated stream, the last one short
  (then padded by ``data/core.pad_batch``).

Any order can be injected instead (``order=``, a function ``(n, seed) →
permutation``); the default is :func:`grain_order`, which
``tests/test_torch_port_grain.py`` holds to grain's own module.

The iterator's state is grain's, ``{"next_index": k}`` (the next batch).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional

import numpy as np

from im2im_uq_tpu_torch.data.core import Batch, pad_batch

__all__ = [
    "CheckpointableBatchIterator",
    "GrainBatches",
    "grain_batches",
    "grain_order",
    "make_grain_dataset",
    "shuffle_seed",
]

Order = Callable[[int, int], np.ndarray]

_M32 = 0xFFFFFFFF
_MIN_BLOCK_BITS = 16
_ROUNDS = 4  # the rounds grain's shuffle passes to index_shuffle


def _seed_seq(seed: int, n: int) -> list[int]:
    """``std::seed_seq({seed}).generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    b = [0x8B8B8B8B] * n
    s = 1
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        r2 = (r1 + (s if k == 0 else k % n + seed if k <= s else k % n)) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _simon_encrypt(v: np.ndarray, keys: list[int], w: int) -> np.ndarray:
    """Grain's ``simon_encrypt<w>`` on a uint64 array: halves of ``w`` bits,
    f(x) = (x <<< 1 & x <<< 8) ^ (x <<< 2), two half-rounds a key pair."""
    mask = np.uint64((1 << w) - 1)

    def rotl(x, r):
        r %= w  # a rotation by w, as bitset<w>'s (x << w) | x, is x
        if r == 0:
            return x
        return ((x << np.uint64(r)) | (x >> np.uint64(w - r))) & mask

    def f(x):
        return (rotl(x, 1) & rotl(x, 8)) ^ rotl(x, 2)

    left, right = (v >> np.uint64(w)) & mask, v & mask
    for i in range(0, len(keys), 2):
        left = left ^ f(right) ^ np.uint64(keys[i] & int(mask))
        right = right ^ f(left) ^ np.uint64(keys[i + 1] & int(mask))
    return (left << np.uint64(w)) | right


def shuffle_seed(seed: int) -> int:
    """The seed grain's ``MapDataset.seed(seed).shuffle()`` shuffles with."""
    return int(np.random.SeedSequence([int(seed), 1]).generate_state(1, np.uint32)[0])


def grain_order(n: int, seed: int) -> np.ndarray:
    """Position → element of one epoch of ``n`` elements shuffled by grain's
    ``index_shuffle(i, n - 1, seed, rounds=4)`` (``seed`` the shuffle's own,
    already derived: :func:`shuffle_seed`).

    The cipher is evaluated once over its whole block, then each position's
    cycle walk (apply it until the value is below ``n``) is taken for all
    values at once by pointer doubling: ``jump[v]`` is where ``v`` has got
    to, ``done[v]`` whether that is below ``n``; a value not done takes the
    jump of the value it reached, which doubles its reach each round."""
    if n <= 1:
        return np.zeros(n, np.int64)
    bits = math.ceil(math.log2(n - 1))
    bits = max(bits + bits % 2, _MIN_BLOCK_BITS)
    keys = _seed_seq(int(seed) & _M32, _ROUNDS)
    jump = _simon_encrypt(np.arange(1 << bits, dtype=np.uint64), keys, bits // 2).astype(np.int64)
    done = jump < n
    todo = np.flatnonzero(~done)
    # a cycle is at most 2^bits long, so bits + 1 rounds end every walk that
    # ends; values on cycles with no element below n never finish, and
    # positions below n never reach them
    for _ in range(bits + 1):
        if not todo.size:
            break
        via = jump[todo]
        jump[todo], done[todo] = jump[via], done[via]
        todo = todo[~done[todo]]
    assert done[:n].all()
    return jump[:n]


class GrainBatches:
    """The map-style view of JAX's ``make_grain_dataset``: batch ``i`` is
    the unpadded ``(x, y)`` pair of stacked items at positions
    ``[i·b, (i+1)·b)`` of the (repeated, shuffled, sharded) stream."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                 num_epochs: int = 1, shard_index: int = 0, shard_count: int = 1,
                 order: Optional[Order] = None):
        if batch_size < 1 or num_epochs < 1:
            raise ValueError("batch_size and num_epochs must be positive")
        self._dataset = dataset
        self._indices = np.arange(len(dataset))[shard_index::shard_count]
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._seed = shuffle_seed(seed) if shuffle else None
        self._order = order or grain_order
        self._epoch_cache: dict[int, np.ndarray] = {}
        self._stream = len(self._indices) * num_epochs

    def __len__(self) -> int:
        return math.ceil(self._stream / self._batch_size)

    def _epoch(self, e: int) -> np.ndarray:
        """Dataset indices of epoch ``e`` in its order (two epochs cached)."""
        if e not in self._epoch_cache:
            n = len(self._indices)
            if self._shuffle:
                perm = np.asarray(self._order(n, (self._seed + e) & _M32), np.int64)
                if not np.array_equal(np.sort(perm), np.arange(n)):
                    raise ValueError("the order is not a permutation of the shard")
                idx = self._indices[perm]
            else:
                idx = self._indices
            if len(self._epoch_cache) >= 2:
                self._epoch_cache.pop(min(self._epoch_cache))
            self._epoch_cache[e] = idx
        return self._epoch_cache[e]

    def indices(self, i: int) -> np.ndarray:
        """Dataset indices of batch ``i``."""
        if not 0 <= i < len(self):
            raise IndexError(f"batch {i} out of range")
        n = len(self._indices)
        positions = np.arange(i * self._batch_size, min((i + 1) * self._batch_size, self._stream))
        out = np.empty(len(positions), np.int64)
        for e in np.unique(positions // n):
            sel = positions // n == e
            out[sel] = self._epoch(int(e))[positions[sel] % n]
        return out

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        items = [self._dataset[int(k)] for k in self.indices(i)]
        return (np.stack([np.asarray(it[0]) for it in items]),
                np.stack([np.asarray(it[1]) for it in items]))


def make_grain_dataset(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                       num_epochs: int = 1, shard_index: int = 0,
                       shard_count: int = 1, order: Optional[Order] = None) -> GrainBatches:
    """The batches of the JAX pipeline over a map-style (x, y) dataset, as a
    map-style view (:class:`GrainBatches`)."""
    return GrainBatches(dataset, batch_size, shuffle=shuffle, seed=seed,
                        num_epochs=num_epochs, shard_index=shard_index,
                        shard_count=shard_count, order=order)


def grain_batches(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                  shard_index: int = 0, shard_count: int = 1, pad_final: bool = True,
                  pad_mode: str = "zeros", order: Optional[Order] = None) -> Iterator[Batch]:
    """Yield one epoch of (x, y, mask) batches in the pipeline's order,
    padded to fixed shapes."""
    yield from CheckpointableBatchIterator(
        dataset, batch_size, shuffle=shuffle, seed=seed, shard_index=shard_index,
        shard_count=shard_count, pad_final=pad_final, pad_mode=pad_mode, order=order)


class CheckpointableBatchIterator:
    """Mid-epoch-resumable (x, y, mask) batch iterator.

    ``get_state()`` is grain's JSON-able ``{"next_index": k}``; a new
    iterator built with the same arguments continues from
    ``set_state(state)`` with batch ``k``.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                 num_epochs: int = 1, shard_index: int = 0, shard_count: int = 1,
                 pad_final: bool = True, pad_mode: str = "zeros",
                 order: Optional[Order] = None):
        self._batches = make_grain_dataset(
            dataset, batch_size, shuffle=shuffle, seed=seed, num_epochs=num_epochs,
            shard_index=shard_index, shard_count=shard_count, order=order)
        self._batch_size = batch_size
        self._pad_final = pad_final
        self._pad_mode = pad_mode
        self._next = 0

    def get_state(self) -> dict:
        return {"next_index": self._next}

    def set_state(self, state: dict) -> None:
        k = int(state["next_index"])
        if not 0 <= k <= len(self._batches):
            raise IndexError(
                f"Checkpoint `next_index` {k} is out of range for dataset of length "
                f"{len(self._batches)}."
            )
        self._next = k

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self._next >= len(self._batches):
            raise StopIteration
        xb, yb = self._batches[self._next]
        self._next += 1
        return pad_batch(xb, yb, self._batch_size, self._pad_mode, self._pad_final)
