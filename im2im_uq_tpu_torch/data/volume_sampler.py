"""Volume-granular shard sampler for multi-host input pipelines.

Counterpart of the reference VolumeSampler (reference: core/datasets/
fastmri/volume_sampler.py:17-115, the repo's only torch.distributed code —
present but never constructed by its pipeline). Contract preserved: all
slices of an MRI volume land on the same shard; volumes are dealt
round-robin across shards by sorted name; every shard is padded to the
max shard length by repeating its own indices; shuffling is deterministic
in (seed + epoch).

Role: in a multi-process deployment each process feeds its own GPU, so
each process constructs this sampler with the shard index and count that
the caller passes, its ``torch.distributed`` rank and world size
(``parallel/distributed.process_shard_info()``), and batches only its shard
of the example list — volume locality keeps per-volume mask RNG and HDF5
file handles process-local.

The port's copy of ``im2im_uq_tpu/data/volume_sampler.py`` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["VolumeShardSampler"]


class VolumeShardSampler:
    """Equal-length, volume-grouped index shards with epoch-seeded shuffle."""

    def __init__(
        self,
        volume_names: Sequence[str],
        num_shards: int,
        shard_index: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        """``volume_names[i]`` is the volume (file) name of example ``i``."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        all_names = sorted(set(str(v) for v in volume_names))
        # deal volumes round-robin by sorted order (volume_sampler.py:66-78)
        owner = {
            name: i % num_shards for i, name in enumerate(all_names)
        }
        shard_indices: list[list[int]] = [[] for _ in range(num_shards)]
        for i, v in enumerate(volume_names):
            shard_indices[owner[str(v)]].append(i)

        self.num_samples = max(len(ix) for ix in shard_indices)
        self.total_size = self.num_samples * num_shards
        self._indices = shard_indices[shard_index]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> list[int]:
        """This shard's example indices, padded to ``num_samples`` by repetition."""
        idx = list(self._indices)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = [idx[j] for j in rng.permutation(len(idx))]
        repeat = self.num_samples // len(idx)
        idx = idx * repeat
        idx = idx + idx[: self.num_samples - len(idx)]
        assert len(idx) == self.num_samples
        return idx

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
