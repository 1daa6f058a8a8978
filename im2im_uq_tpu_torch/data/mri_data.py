"""Generic fastMRI slice datasets with metadata caching and sampling.

Counterpart of the reference's fastMRI-extras layer (reference:
core/datasets/fastmri/mri_data.py:58-360 — ``fetch_dir``, ``SliceDataset``
with a metadata pickle cache and slice/volume sample rates,
``CombinedSliceDataset``; unused by the reference's main path but part of
its public surface). Same behaviors:

- ``fetch_dir``: YAML path config with template auto-creation;
- ``SliceDataset``: walks HDF5 volumes, caches the parsed (fname, slice,
  metadata) example list in a pickle keyed by root when
  ``use_dataset_cache``; mutually-exclusive ``sample_rate`` (by slice,
  shuffled) / ``volume_sample_rate`` (by volume stem, shuffled); optional
  ``num_cols`` filter on encoded width;
- ``CombinedSliceDataset``: concatenation container.

Transforms follow the reference callable contract
(kspace, mask, target, attrs, fname, slice) → sample.

Provenance note: the reference vendored this module from
facebookresearch/fastMRI (MIT); the ``fetch_dir`` key set
(knee_path/brain_path/log_path) and template-YAML behavior are that
upstream's config-file contract, which users' existing
``fastmri_dirs.yaml`` files depend on — the keys are therefore kept
verbatim while the code is an independent implementation.

The port's copy of ``im2im_uq_tpu/data/mri_data.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import logging
import os
import pickle
import random
import warnings
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import yaml

from im2im_uq_tpu_torch.data.fastmri import et_query

__all__ = ["fetch_dir", "SliceDataset", "CombinedSliceDataset"]


def fetch_dir(
    key: str, data_config_file: Union[str, Path, os.PathLike] = "fastmri_dirs.yaml"
) -> Path:
    """YAML-config data-directory fetcher (mri_data.py:58-98); writes a
    template config and warns when none exists."""
    data_config_file = Path(data_config_file)
    if not data_config_file.is_file():
        default_config = {
            "knee_path": "/path/to/knee",
            "brain_path": "/path/to/brain",
            "log_path": ".",
        }
        with open(data_config_file, "w") as fh:
            yaml.dump(default_config, fh)
        warnings.warn(
            f"No path config found at {data_config_file.resolve()}; wrote a "
            "template there — fill in the data directories for this machine "
            "before relying on the returned default."
        )
        return Path(default_config[key])
    with open(data_config_file) as fh:
        return Path(yaml.safe_load(fh)[key])


class SliceDataset:
    """Map-style access to raw (or transformed) MR slices (mri_data.py:195-360)."""

    def __init__(
        self,
        root: Union[str, Path, os.PathLike],
        challenge: str,
        transform: Optional[Callable] = None,
        use_dataset_cache: bool = False,
        sample_rate: Optional[float] = None,
        volume_sample_rate: Optional[float] = None,
        dataset_cache_file: Union[str, Path, os.PathLike] = "dataset_cache.pkl",
        num_cols: Optional[Tuple[int, ...]] = None,
    ):
        import h5py

        self._h5py = h5py
        if challenge not in ("singlecoil", "multicoil"):
            raise ValueError('challenge should be either "singlecoil" or "multicoil"')
        if sample_rate is not None and volume_sample_rate is not None:
            raise ValueError(
                "either set sample_rate (sample by slices) or volume_sample_rate "
                "(sample by volumes) but not both"
            )
        self.dataset_cache_file = Path(dataset_cache_file)
        self.transform = transform
        self.recons_key = (
            "reconstruction_esc" if challenge == "singlecoil" else "reconstruction_rss"
        )
        self.examples: list[tuple[Path, int, dict]] = []

        sample_rate = 1.0 if sample_rate is None else sample_rate
        volume_sample_rate = 1.0 if volume_sample_rate is None else volume_sample_rate

        dataset_cache = {}
        if self.dataset_cache_file.exists() and use_dataset_cache:
            with open(self.dataset_cache_file, "rb") as fh:
                dataset_cache = pickle.load(fh)

        if dataset_cache.get(root) is None or not use_dataset_cache:
            for fname in sorted(Path(root).iterdir()):
                metadata, num_slices = self._retrieve_metadata(fname)
                self.examples += [(fname, s, metadata) for s in range(num_slices)]
            if dataset_cache.get(root) is None and use_dataset_cache:
                dataset_cache[root] = self.examples
                logging.info("Saving dataset cache to %s.", self.dataset_cache_file)
                with open(self.dataset_cache_file, "wb") as fh:
                    pickle.dump(dataset_cache, fh)
        else:
            logging.info("Using dataset cache from %s.", self.dataset_cache_file)
            self.examples = dataset_cache[root]

        if sample_rate < 1.0:  # by slice
            random.shuffle(self.examples)
            self.examples = self.examples[: round(len(self.examples) * sample_rate)]
        elif volume_sample_rate < 1.0:  # by volume
            vol_names = sorted({f[0].stem for f in self.examples})
            random.shuffle(vol_names)
            keep = set(vol_names[: round(len(vol_names) * volume_sample_rate)])
            self.examples = [ex for ex in self.examples if ex[0].stem in keep]

        if num_cols:
            self.examples = [
                ex for ex in self.examples if ex[2]["encoding_size"][1] in num_cols
            ]

    def _retrieve_metadata(self, fname) -> tuple[dict, int]:
        import xml.etree.ElementTree as etree

        with self._h5py.File(fname, "r") as hf:
            root = etree.fromstring(hf["ismrmrd_header"][()])
            enc = ["encoding", "encodedSpace", "matrixSize"]
            enc_size = tuple(int(et_query(root, enc + [d])) for d in "xyz")
            rec = ["encoding", "reconSpace", "matrixSize"]
            recon_size = tuple(int(et_query(root, rec + [d])) for d in "xyz")
            lims = ["encoding", "encodingLimits", "kspace_encoding_step_1"]
            center = int(et_query(root, lims + ["center"]))
            maximum = int(et_query(root, lims + ["maximum"])) + 1
            padding_left = enc_size[1] // 2 - center
            num_slices = hf["kspace"].shape[0]
        return (
            {
                "padding_left": padding_left,
                "padding_right": padding_left + maximum,
                "encoding_size": enc_size,
                "recon_size": recon_size,
            },
            num_slices,
        )

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int):
        fname, dataslice, metadata = self.examples[i]
        with self._h5py.File(fname, "r") as hf:
            kspace = hf["kspace"][dataslice]
            mask = np.asarray(hf["mask"]) if "mask" in hf else None
            target = hf[self.recons_key][dataslice] if self.recons_key in hf else None
            attrs = dict(hf.attrs)
            attrs.update(metadata)
        if self.transform is None:
            return kspace, mask, target, attrs, fname.name, dataslice
        return self.transform(kspace, mask, target, attrs, fname.name, dataslice)


class CombinedSliceDataset:
    """Concatenation of SliceDatasets (mri_data.py:101-192)."""

    def __init__(
        self,
        roots: Sequence[Path],
        challenges: Sequence[str],
        transforms: Optional[Sequence[Optional[Callable]]] = None,
        sample_rates: Optional[Sequence[Optional[float]]] = None,
        volume_sample_rates: Optional[Sequence[Optional[float]]] = None,
        use_dataset_cache: bool = False,
        dataset_cache_file: Union[str, Path, os.PathLike] = "dataset_cache.pkl",
        num_cols: Optional[Tuple[int, ...]] = None,
    ):
        if sample_rates is not None and volume_sample_rates is not None:
            raise ValueError(
                "either set sample_rates (sample by slices) or volume_sample_rates "
                "(sample by volumes) but not both"
            )
        transforms = transforms or [None] * len(roots)
        sample_rates = sample_rates or [None] * len(roots)
        volume_sample_rates = volume_sample_rates or [None] * len(roots)
        if not (
            len(roots)
            == len(transforms)
            == len(challenges)
            == len(sample_rates)
            == len(volume_sample_rates)
        ):
            raise ValueError(
                "Lengths of roots, transforms, challenges, sample_rates do not match"
            )
        self.datasets = [
            SliceDataset(
                root=roots[i],
                challenge=challenges[i],
                transform=transforms[i],
                sample_rate=sample_rates[i],
                volume_sample_rate=volume_sample_rates[i],
                use_dataset_cache=use_dataset_cache,
                dataset_cache_file=dataset_cache_file,
                num_cols=num_cols,
            )
            for i in range(len(roots))
        ]
        self.examples = [ex for ds in self.datasets for ex in ds.examples]

    def __len__(self) -> int:
        return sum(len(ds) for ds in self.datasets)

    def __getitem__(self, i: int):
        for ds in self.datasets:
            if i < len(ds):
                return ds[i]
            i -= len(ds)
        raise IndexError(i)
