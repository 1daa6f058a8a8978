"""FastMRI HDF5 slice dataset with ISMRMRD metadata and dataset-level
normalization.

Counterpart of the reference FastMRI data layer (reference:
core/datasets/fastmri/FastMRIDataset.py:50-163 and the ``et_query`` ISMRMRD
XML helper, FastMRIDataset.py:18-47): walks a directory of HDF5 volumes,
parses encoded/recon sizes from the ISMRMRD header, builds a shuffled
per-slice example list with ``num_volumes``/``slice_sample_period``
subsampling, pushes each slice through UnetDataTransform, and applies
dataset-level normalization post-hoc once ``norm_params`` is attached by
``normalize_dataset``.

Returns NHWC (H, W, 1) float32 pairs (the reference returns (1, H, W)
torch tensors).

Preserved reference quirks:
- 'min-max' per-item normalization divides by max, not (max − min)
  (FastMRIDataset.py:150-158) — unlike the eager normalize in
  datasets/utils.py;
- the transform is built with ``use_seed=False`` (FastMRIDataset.py:88), so
  each access draws a fresh random mask;
- volume order and the example list are shuffled with the *global* python
  RNG (FastMRIDataset.py:70,82), which fix_randomness seeds.

The port's copy of ``im2im_uq_tpu/data/fastmri.py`` (the port imports
nothing of the JAX package). ``FastMRIDataset.device_preprocess`` is the
torch closure of the on-device transform: with ``return_kspace`` on, the
loader ships masked k-space and the train step reconstructs the input on
the model's device (``ops/mri_pipeline.py``).

For hermetic tests/benchmarks, ``write_synthetic_volume`` emits HDF5 files
in the exact fastMRI schema (kspace, reconstruction_esc, ismrmrd_header).
"""

from __future__ import annotations

import os
import random
import xml.etree.ElementTree as etree
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from im2im_uq_tpu_torch.data import subsample
from im2im_uq_tpu_torch.data.transforms import UnetDataTransform, fft2c_np, to_real_pair

__all__ = ["et_query", "FastMRIDataset", "write_synthetic_volume"]

_ISMRMRD_NS = "http://www.ismrm.org/ISMRMRD"


def et_query(root, qlist: Sequence[str], namespace: str = _ISMRMRD_NS) -> str:
    """Nested namespaced ElementTree lookup (reference FastMRIDataset.py:18-47)."""
    prefix = "ismrmrd_namespace"
    query = "." + "".join(f"//{prefix}:{el}" for el in qlist)
    value = root.find(query, {prefix: namespace})
    if value is None:
        raise RuntimeError("Element not found")
    return str(value.text)


class FastMRIDataset:
    """Map-style dataset of undersampled-MRI (input, target) slice pairs."""

    # the h5py module handle is dropped on pickle and re-imported on
    # restore, so the dataset ships cleanly to worker processes
    # (data.core.ProcessPoolFetcher, grain workers)
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_h5py", None)
        return state

    def __setstate__(self, state):
        import h5py

        self.__dict__.update(state)
        self._h5py = h5py

    def __init__(
        self,
        path: str,
        normalize_input: str,
        normalize_output: str,
        mask_info: dict,
        num_volumes: Optional[int] = None,
        slice_sample_period: int = 1,
        return_kspace: bool = False,
    ):
        import h5py

        self._h5py = h5py
        path = os.path.expanduser(path)
        self.norm_params: Optional[dict] = None
        self.challenge = "singlecoil"
        self.recons_key = (
            "reconstruction_esc" if self.challenge == "singlecoil" else "reconstruction_rss"
        )
        self.cache_path = os.path.join(path, ".cache/")
        os.makedirs(self.cache_path, exist_ok=True)

        files = [f for f in Path(path).iterdir() if "cache" not in str(f)]
        files = sorted(files)
        random.shuffle(files)
        if num_volumes and num_volumes < len(files):
            files = files[:num_volumes]
        print(f"Loading {len(files)} volumes...")

        self.examples: list[tuple[Path, int, dict]] = []
        for fname in files:
            metadata, num_slices = self._retrieve_metadata(fname)
            assert num_slices > slice_sample_period
            self.examples += [
                (fname, s, metadata) for s in range(0, num_slices, slice_sample_period)
            ]
        print(f"Using {len(self.examples)} total slices")
        random.shuffle(self.examples)

        mask_func = subsample.create_mask_for_mask_type(
            mask_info["type"], mask_info["center_fraction"], mask_info["acceleration"]
        )
        self.transform = UnetDataTransform(self.challenge, mask_func=mask_func, use_seed=False)
        self.normalize_input = normalize_input
        self.normalize_output = normalize_output
        self.return_kspace = return_kspace

    def _retrieve_metadata(self, fname) -> tuple[dict, int]:
        """Parse ISMRMRD enc/recon sizes + k-space padding (FastMRIDataset.py:93-126)."""
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
            padding_right = padding_left + maximum
            num_slices = hf["kspace"].shape[0]
        metadata = {
            "padding_left": padding_left,
            "padding_right": padding_right,
            "encoding_size": enc_size,
            "recon_size": recon_size,
        }
        return metadata, num_slices

    def __len__(self) -> int:
        return len(self.examples)

    def _apply_norm(self, img: np.ndarray, which: str, tag: str) -> np.ndarray:
        if self.norm_params is None:
            return img
        p = self.norm_params
        if which == "standard":
            return (img - p[f"{tag}_mean"]) / p[f"{tag}_std"]
        if which == "min-max":
            # reference quirk: divides by max, not (max − min)
            # (FastMRIDataset.py:152,157)
            return (img - p[f"{tag}_min"]) / p[f"{tag}_max"]
        return img

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        fname, dataslice, metadata = self.examples[idx]
        with self._h5py.File(fname, "r") as hf:
            kspace = hf["kspace"][dataslice]
            mask = np.asarray(hf["mask"]) if "mask" in hf else None
            target = hf[self.recons_key][dataslice] if self.recons_key in hf else None
            attrs = dict(hf.attrs)
            attrs.update(metadata)

        if self.return_kspace:
            return self._kspace_item(kspace, mask, target, fname.name)
        image, target, *_ = self.transform(kspace, mask, target, attrs, fname.name, dataslice)
        image = self._apply_norm(image, self.normalize_input, "input")
        target = self._apply_norm(target, self.normalize_output, "output")
        # NHWC single-channel pairs (reference emits (1, H, W) CHW)
        return (
            np.asarray(image, np.float32)[..., None],
            np.asarray(target, np.float32)[..., None],
        )

    def _kspace_item(self, kspace, mask, target, fname: str):
        """Raw-kspace mode for the on-device pipeline (ops/mri_pipeline.py):
        returns (masked k-space real-pair (H, W, 2), normalized target) —
        masking stays on the host (tiny, and preserves the mask-RNG
        semantics); IFFT/crop/magnitude/input-normalization run on the
        device via ``device_preprocess``. Mask seeding mirrors
        UnetDataTransform (fresh mask per access under the default
        use_seed=False)."""
        from im2im_uq_tpu_torch.data.transforms import apply_mask, center_crop

        pair = to_real_pair(np.asarray(kspace))
        if self.transform.mask_func and mask is None:
            seed = tuple(map(ord, fname)) if self.transform.use_seed else None
            pair, _ = apply_mask(pair, self.transform.mask_func, seed)
        crop = (target.shape[-2], target.shape[-1])
        target = center_crop(np.asarray(target), crop)
        target = self._apply_norm(target, self.normalize_output, "output")
        return (
            np.asarray(pair, np.float32),
            np.asarray(target, np.float32)[..., None],
        )

    def device_preprocess(self, crop: tuple[int, int]):
        """Torch closure reproducing the image-domain input path on the
        k-space batch's device: zero-filled recon (the mask was applied on
        the host) + the dataset's input normalization, (B, H, W, 2) →
        (B, 1, *crop). Pass as ``preprocess`` to make_train_step /
        make_eval_loss_step / train_net; requires ``norm_params`` (run
        normalize_dataset in image mode first, then flip ``return_kspace``
        on)."""
        from im2im_uq_tpu_torch.ops.mri_pipeline import zero_filled_recon

        which, p = self.normalize_input, self.norm_params

        def preprocess(kspace_pair):
            img = zero_filled_recon(kspace_pair, None, crop)
            if p is None:
                return img
            if which == "standard":
                return (img - p["input_mean"]) / p["input_std"]
            if which == "min-max":
                # reference quirk: divides by max, not (max − min)
                return (img - p["input_min"]) / p["input_max"]
            return img

        return preprocess


_HEADER_TEMPLATE = """<?xml version="1.0" encoding="UTF-8"?>
<ismrmrdHeader xmlns="http://www.ismrm.org/ISMRMRD">
  <encoding>
    <encodedSpace>
      <matrixSize><x>{ex}</x><y>{ey}</y><z>1</z></matrixSize>
    </encodedSpace>
    <reconSpace>
      <matrixSize><x>{rx}</x><y>{ry}</y><z>1</z></matrixSize>
    </reconSpace>
    <encodingLimits>
      <kspace_encoding_step_1>
        <center>{center}</center>
        <maximum>{maximum}</maximum>
      </kspace_encoding_step_1>
    </encodingLimits>
  </encoding>
</ismrmrdHeader>
"""


def write_synthetic_volume(
    path: str,
    num_slices: int = 6,
    enc_shape: tuple[int, int] = (64, 40),
    recon_shape: tuple[int, int] = (32, 32),
    seed: int = 0,
) -> str:
    """Write one HDF5 volume in the fastMRI singlecoil schema.

    Smooth random images → orthonormal k-space (kspace dataset, complex64) +
    ground-truth recon (reconstruction_esc) + ISMRMRD header, so the full
    FastMRIDataset/transform path runs without the real download.
    """
    import h5py

    rng = np.random.RandomState(seed)
    h, w = enc_shape
    rh, rw = recon_shape
    images = rng.randn(num_slices, h, w).astype(np.float32)
    # smooth for realism: separable 5-tap box blur
    k = np.ones(5) / 5
    for ax in (1, 2):
        images = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, images)
    kspace = np.empty((num_slices, h, w), np.complex64)
    for i in range(num_slices):
        pair = fft2c_np(to_real_pair(images[i].astype(np.complex64)))
        kspace[i] = pair[..., 0] + 1j * pair[..., 1]
    # target = center-cropped magnitude of the fully-sampled recon
    t0 = (h - rh) // 2
    t1 = (w - rw) // 2
    target = np.abs(images[:, t0 : t0 + rh, t1 : t1 + rw]).astype(np.float32)

    header = _HEADER_TEMPLATE.format(
        ex=h, ey=w, rx=rh, ry=rw, center=w // 2, maximum=w - 1
    )
    with h5py.File(path, "w") as hf:
        hf.create_dataset("kspace", data=kspace)
        hf.create_dataset("reconstruction_esc", data=target)
        hf.create_dataset("ismrmrd_header", data=header.encode())
        hf.attrs["max"] = float(target.max())
        hf.attrs["acquisition"] = "CORPD_FBK"
    return path
