"""TEMCA electron-microscopy tile dataset: buffered streaming patch pipeline.

Counterpart of the reference TEMCA loader (reference: core/datasets/temca/
TEMCADataset.py:19-92): glob PNG tiles, stream ``buffer_size`` images at a
time, grid-slice each into ``patch_size`` patches rejecting patches that are
≥85% zeros (the condition as written keeps patches whose zero-count is
< 0.85·area — preserved), shuffle the patch buffer, then yield
(low-res input, high-res target) pairs where the input is a strided
downsample nearest-upsampled back to the patch size (the reference's
nn.Upsample default mode). ``reset()`` rewinds the stream; the router splits
by partitioning ``img_paths`` across copies (reference router.py:90-100),
exposed here as ``split_by_paths``.

Emits NHWC (H, W, 1) float32 pairs (the reference yields (1, H, W) CHW).

The port's copy of ``im2im_uq_tpu/data/temca.py``: the numpy path only,
which gives the same pairs as the JAX package's optional C++ patch ops.
The raw-uint8 feed (``return_raw``) and ``device_preprocess_pair``, its
torch closure, move the pair's making into the train step on the model's
device. The port imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
import random
from glob import glob
from typing import Iterator, Sequence

import numpy as np

__all__ = ["TEMCADataset", "nearest_upsample"]


def nearest_upsample(x: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize of a 2-D array to ``out_hw``.

    Matches torch nn.Upsample(mode='nearest'): src = floor(dst * in/out).
    """
    h, w = x.shape
    rows = (np.arange(out_hw[0]) * h // out_hw[0]).astype(np.int64)
    cols = (np.arange(out_hw[1]) * w // out_hw[1]).astype(np.int64)
    return x[rows][:, cols]


class TEMCADataset:
    """Iterable dataset of super-resolution patch pairs from giant EM tiles."""

    def __init__(
        self,
        path: str,
        patch_size: Sequence[int],
        downsampling: Sequence[int],
        num_imgs="all",
        buffer_size: int = 10,
        normalize: str | None = "01",
    ):
        print(f"loading dataset from : {path}...")
        self.path = path
        self.output_size = tuple(patch_size)
        self.downsampling = tuple(downsampling)
        self.buffer_size = buffer_size
        self.normalize = normalize
        self.img_index = 0
        self.patch_buffer: list[np.ndarray] = []
        self.norm_params: dict = {}
        self.cache_path = None
        self.return_raw = False  # see device_preprocess_pair

        self.img_paths = sorted(glob(path + "**/*.png", recursive=True))
        random.shuffle(self.img_paths)
        if num_imgs != "all":
            self.img_paths = self.img_paths[: int(num_imgs)]
        print(f"using {len(self.img_paths)} full images")

    # -- streaming machinery -------------------------------------------------

    def reset(self) -> None:
        self.img_index = 0
        self.patch_buffer = []

    def _read_image(self, path: str) -> np.ndarray:
        import imageio

        return np.asarray(imageio.imread(path))

    def _extract_patches(self, img: np.ndarray) -> None:
        ph, pw = self.output_size
        for r in range(img.shape[0] // ph):
            for c in range(img.shape[1] // pw):
                patch = img[r * ph : (r + 1) * ph, c * pw : (c + 1) * pw]
                # keep unless ≥85% of pixels are zero (reference TEMCADataset.py:74)
                if np.count_nonzero(patch == 0) < 0.85 * (ph * pw):
                    self.patch_buffer.append(patch)

    def _fill_buffer(self) -> None:
        # Tail-wrap quirk preserved from the reference (TEMCADataset.py:48-51):
        # when buffer_size does not divide the path count, the final fill sets
        # end = len - img_index (not len), so the slice is empty, the cursor
        # wraps, and one "epoch" re-extracts most tiles a second time before
        # terminating. Kept bit-for-bit for epoch-accounting parity.
        if self.img_index + self.buffer_size > len(self.img_paths):
            if len(self.img_paths) - self.img_index > 0:
                end = len(self.img_paths) - self.img_index
            else:
                self.img_index = -1
                return
        else:
            end = self.img_index + self.buffer_size
        for p in self.img_paths[self.img_index : end]:
            self._extract_patches(self._read_image(p))
        random.shuffle(self.patch_buffer)
        self.img_index = end

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while self.img_index != -1:
            if not self.patch_buffer:
                self._fill_buffer()
            if self.patch_buffer:
                patch = self.patch_buffer.pop()
                if self.return_raw:
                    # raw-uint8 feed for the on-device transform
                    # (device_preprocess_pair): the patch bytes ship once as
                    # input AND target, 2 bytes a pixel instead of two
                    # float32 images' 8
                    raw = patch[..., None]
                    yield raw, raw
                    continue
                gt = patch.astype(np.float32)
                if self.normalize == "01":
                    gt = gt / 255.0
                elif self.normalize == "-11":
                    gt = 2.0 * (gt / 255.0 - 0.5)
                low = gt[:: self.downsampling[0], :: self.downsampling[1]]
                low = nearest_upsample(low, self.output_size)
                yield low[..., None], gt[..., None]
        self.img_index = 0

    # -- router integration --------------------------------------------------

    def split_by_paths(self, percentages: Sequence[float], rng=None):
        """(train, calib, val) copies with partitioned tile paths
        (reference router.py:90-100: rounded lengths, shuffled paths,
        deep copies with path slices)."""
        paths = list(self.img_paths)
        lengths = np.round(len(paths) * np.asarray(percentages)).astype(int)
        lengths[-1] = len(paths) - (lengths.sum() - lengths[-1])
        random.shuffle(paths)
        out = []
        ofs = 0
        for ln in lengths[:3]:
            part = copy.deepcopy(self)
            part.img_paths = paths[ofs : ofs + ln]
            part.reset()
            out.append(part)
            ofs += ln
        return tuple(out)

    def device_preprocess_pair(self):
        """Torch closure reproducing the patch → pair transform on the
        batch's device.

        With ``return_raw`` on, the loader ships each uint8 patch once and
        this closure, passed as ``preprocess_pair`` to make_train_step /
        make_eval_loss_step / train_net, takes the NCHW uint8 batches
        (B, 1, ph, pw) to (low-res input, normalized target) in float32:
        the normalization, then the strided downsample and the nearest
        upsample composed into one row and one column gather
        (low[i, j] = gt[d0·⌊i·h_low/ph⌋, d1·⌊j·w_low/pw⌋]). The pair is the
        host path's bit for bit: the indices are exact, and the division by
        255 divides by a tensor (PyTorch's CUDA division by a Python number
        multiplies by its reciprocal instead).
        """
        import torch

        ph, pw = self.output_size
        d0, d1 = self.downsampling
        h_low = len(range(0, ph, d0))
        w_low = len(range(0, pw, d1))
        rows = torch.from_numpy((np.arange(ph) * h_low // ph) * d0)
        cols = torch.from_numpy((np.arange(pw) * w_low // pw) * d1)
        normalize = self.normalize
        on_device: dict = {}  # the indices and the divisor, once per device

        def preprocess_pair(x_raw, y_raw):
            if y_raw.device not in on_device:
                on_device[y_raw.device] = (rows.to(y_raw.device), cols.to(y_raw.device),
                                           torch.full((), 255.0, device=y_raw.device))
            r, c, d = on_device[y_raw.device]
            gt = y_raw.to(torch.float32)
            if normalize == "01":
                gt = gt / d
            elif normalize == "-11":
                gt = 2.0 * (gt / d - 0.5)
            low = gt.index_select(2, r).index_select(3, c)
            return low, gt

        return preprocess_pair
