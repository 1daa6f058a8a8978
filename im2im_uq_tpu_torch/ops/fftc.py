"""Centered FFTs and complex helpers over real-pair encoded tensors.

Counterpart of ``im2im_uq_tpu/ops/fftc.py`` (the reference's MRI physics
stack: ``fft2c_new``/``ifft2c_new``, the complex helpers and ``rss``).
Complex values are stored as real tensors with a trailing dim of size 2
(re, im); FFTs are orthonormal and centered (ifftshift → fft2 → fftshift
over the two spatial dims).

``torch.view_as_complex`` reads a real pair as a complex tensor without a
copy. It needs the pair to be the innermost, unit-stride dim of a float32
(or float64) tensor: the entry points that transform (:func:`fft2c`,
:func:`ifft2c`) make their input contiguous once, which is no copy for the
loader's batches; :func:`to_complex` itself never copies and raises on a
tensor it cannot view.
"""

from __future__ import annotations

import torch

__all__ = [
    "to_complex",
    "from_complex",
    "fft2c",
    "ifft2c",
    "complex_mul",
    "complex_conj",
    "complex_abs",
    "complex_abs_sq",
    "rss",
    "rss_complex",
]


def _check_pair(data: torch.Tensor) -> None:
    if data.shape[-1] != 2:
        raise ValueError("Tensor does not have separate complex dim.")


def to_complex(data: torch.Tensor) -> torch.Tensor:
    """(..., 2) real-pair → complex, a view of the same storage."""
    _check_pair(data)
    return torch.view_as_complex(data)


def from_complex(data: torch.Tensor) -> torch.Tensor:
    """complex → (..., 2) real-pair, a view of the same storage."""
    return torch.view_as_real(data)


def _centered(transform, data: torch.Tensor) -> torch.Tensor:
    """ifftshift → 2-D ortho transform → fftshift on dims (-3, -2) of a
    real-pair tensor (the reference's centered-FFT recipe)."""
    _check_pair(data)
    z = to_complex(data.contiguous())
    z = torch.fft.ifftshift(z, dim=(-2, -1))
    z = transform(z, dim=(-2, -1), norm="ortho")
    z = torch.fft.fftshift(z, dim=(-2, -1))
    return from_complex(z)


def fft2c(data: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2-D FFT (reference ``fft2c_new``)."""
    return _centered(torch.fft.fft2, data)


def ifft2c(data: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2-D IFFT (reference ``ifft2c_new``)."""
    return _centered(torch.fft.ifft2, data)


def complex_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise complex product of real-pair tensors."""
    if not (x.shape[-1] == y.shape[-1] == 2):
        raise ValueError("Tensors do not have separate complex dim.")
    re = x[..., 0] * y[..., 0] - x[..., 1] * y[..., 1]
    im = x[..., 0] * y[..., 1] + x[..., 1] * y[..., 0]
    return torch.stack([re, im], dim=-1)


def complex_conj(x: torch.Tensor) -> torch.Tensor:
    """Complex conjugate of a real-pair tensor."""
    _check_pair(x)
    return torch.stack([x[..., 0], -x[..., 1]], dim=-1)


def complex_abs(data: torch.Tensor) -> torch.Tensor:
    """|z| of a real-pair tensor."""
    _check_pair(data)
    return torch.sqrt((data * data).sum(dim=-1))


def complex_abs_sq(data: torch.Tensor) -> torch.Tensor:
    """|z|² of a real-pair tensor."""
    _check_pair(data)
    return (data * data).sum(dim=-1)


def rss(data: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Root-sum-of-squares coil combine."""
    return torch.sqrt((data * data).sum(dim=axis))


def rss_complex(data: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """RSS over a coil axis of real-pair data."""
    return torch.sqrt(complex_abs_sq(data).sum(dim=axis))
