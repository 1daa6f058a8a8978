"""K2: the RCPS fraction-missed loss table.

Counterpart of ``im2im_uq_tpu/ops/pallas_kernels.py``. On CUDA tensors
:func:`loss_table` launches the hand-written kernel in ``csrc/loss_table.cu``;
on CPU tensors it runs :func:`loss_table_plain`, the same count in PyTorch
ops. Nothing else picks between the two.

A pixel is missed at λ when ``(a > 1e-6 & λ·dl < a) | (b > 1e-6 & λ·du < b)``
with a = pred − label and b = −a; the table holds count / P. This is the
direct method's set test (``ops/sets.py``) rearranged, and the two agree
except at exact float ties of λ·slope and the residual.
"""

from __future__ import annotations

import torch

from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.ops.sets import COLLAPSE_EPS, divide_counts

__all__ = ["loss_table", "loss_table_plain"]

# The plain version holds at most this many (λ, example, pixel) booleans at once.
_PLAIN_CHUNK_ELEMS = 1 << 26


def loss_table_plain(
    pred: torch.Tensor,
    label: torch.Tensor,
    dl: torch.Tensor,
    du: torch.Tensor,
    lam: torch.Tensor,
) -> torch.Tensor:
    """K2's plain version: (N, P) maps and (L,) λ → (N, L), chunked over λ."""
    n, p = pred.shape
    a = pred - label
    b = -a
    lo_possible = a > COLLAPSE_EPS
    hi_possible = b > COLLAPSE_EPS
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, n * p))
    counts = []
    for start in range(0, lam.shape[0], chunk):
        lam_c = lam[start : start + chunk, None, None]  # (Lc, 1, 1)
        miss = (lo_possible & (lam_c * dl < a)) | (hi_possible & (lam_c * du < b))
        counts.append(miss.sum(dim=2))  # (Lc, N) exact integer counts
    if not counts:
        return torch.zeros((n, 0), dtype=torch.float32, device=pred.device)
    return divide_counts(torch.cat(counts, dim=0).T, p)


def _launch(pred, label, dl, du, lam) -> torch.Tensor:
    maps = (pred, label, dl, du)
    if pred.ndim != 2 or lam.ndim != 1:
        raise ValueError(
            f"loss_table kernel takes (N, P) maps and an (L,) grid, got "
            f"{tuple(pred.shape)} and {tuple(lam.shape)}"
        )
    for t in (*maps, lam):
        if t.device != pred.device:
            raise ValueError("loss_table kernel inputs must lie on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"loss_table kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("loss_table kernel takes contiguous tensors")
    if any(t.shape != pred.shape for t in maps):
        raise ValueError("loss_table kernel takes pred, label, dl, du of one shape")
    n, p = pred.shape
    num_lam = lam.shape[0]
    if n > 65535:
        raise ValueError(f"loss_table kernel takes at most 65535 examples, got {n}")
    out = torch.empty((n, num_lam), dtype=torch.float32, device=pred.device)
    if out.numel() == 0:
        return out
    err = _build.library().im2im_loss_table(
        pred.data_ptr(), label.data_ptr(), dl.data_ptr(), du.data_ptr(),
        lam.data_ptr(), out.data_ptr(), n, p, num_lam, pred.device.index,
        torch.cuda.current_stream(pred.device).cuda_stream,
    )
    loss_table.launches += 1
    _build.check(err, "loss_table")
    return out


def loss_table(
    pred: torch.Tensor,
    label: torch.Tensor,
    dl: torch.Tensor,
    du: torch.Tensor,
    lam: torch.Tensor,
) -> torch.Tensor:
    """(N, L) fraction-missed table from (N, P) f32 maps and an (L,) f32 grid.

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; any other device raises.
    """
    if pred.device.type == "cuda":
        return _launch(pred, label, dl, du, lam)
    if pred.device.type == "cpu":
        return loss_table_plain(pred, label, dl, du, lam)
    raise RuntimeError(f"loss_table runs on cuda or cpu tensors, not {pred.device}")


loss_table.launches = 0  # kernel launches since the last reset
