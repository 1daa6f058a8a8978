"""Port parity: the centered FFTs, the complex helpers and the zero-filled
reconstruction (``ops/fftc.py``, ``ops/mri_pipeline.py``) against the JAX
package's on the same real-pair arrays, made from a numpy seed.

Bars: rtol 1e-5 / atol 1e-6 against the JAX functions (measured: at most
1e-6 absolute on values of order 3, the FFTs' f32 rounding; the products,
conjugates and squared magnitudes equal), and the JAX test's rtol 2e-4 /
atol 1e-5 against the host ``UnetDataTransform`` (numpy's FFT,
``tests/test_mri_pipeline.py``). The reconstruction comes out NCHW where the
JAX one is NHWC.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu.ops import fftc as jfftc
from im2im_uq_tpu.ops import mri_pipeline as jmri

from im2im_uq_tpu_torch.data.subsample import create_mask_for_mask_type
from im2im_uq_tpu_torch.data.transforms import UnetDataTransform, apply_mask, to_real_pair
from im2im_uq_tpu_torch.ops import fftc as tfftc
from im2im_uq_tpu_torch.ops import mri_pipeline as tmri
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6


def _pair(seed: int, shape: tuple) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randn(*shape, 2).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["fft2c", "ifft2c", "complex_conj", "complex_abs",
                                  "complex_abs_sq"])
def test_unary_functions_match_jax(name):
    x = _pair(0, (3, 24, 20))
    _close(getattr(tfftc, name)(torch.from_numpy(x)), getattr(jfftc, name)(jnp.asarray(x)))


def test_complex_mul_matches_jax():
    x, y = _pair(1, (2, 8, 6)), _pair(2, (2, 8, 6))
    _close(tfftc.complex_mul(torch.from_numpy(x), torch.from_numpy(y)),
           jfftc.complex_mul(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("axis", [0, 1])
def test_rss_and_rss_complex_match_jax(axis):
    x = _pair(3, (4, 3, 10, 12))
    _close(tfftc.rss(torch.from_numpy(x), axis), jfftc.rss(jnp.asarray(x), axis))
    _close(tfftc.rss_complex(torch.from_numpy(x), axis), jfftc.rss_complex(jnp.asarray(x), axis))


def test_to_complex_is_a_view_and_round_trips():
    x = torch.from_numpy(_pair(4, (2, 6, 5)))
    z = tfftc.to_complex(x)
    assert z.dtype == torch.complex64 and z.shape == (2, 6, 5)
    assert z.data_ptr() == x.data_ptr()  # no copy
    back = tfftc.from_complex(z)
    assert back.data_ptr() == x.data_ptr() and torch.equal(back, x)
    want = jfftc.to_complex(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(z.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tfftc.from_complex(z).numpy(),
                                  np.asarray(jfftc.from_complex(want)))
    # a pair that is not innermost cannot be viewed: it raises, never copies
    planar = x.movedim(-1, 0).contiguous().movedim(0, -1)  # re and im planes apart
    assert planar.stride(-1) != 1
    with pytest.raises(RuntimeError):
        tfftc.to_complex(planar)
    torch.testing.assert_close(tfftc.fft2c(planar), tfftc.fft2c(x), rtol=0, atol=0)


def test_ffts_invert_each_other_and_keep_the_input():
    x = torch.from_numpy(_pair(5, (2, 16, 12)))
    before = x.clone()
    back = tfftc.ifft2c(tfftc.fft2c(x))
    assert torch.equal(x, before)
    torch.testing.assert_close(back, x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["to_complex", "fft2c", "ifft2c", "complex_conj",
                                  "complex_abs", "complex_abs_sq", "rss_complex"])
def test_the_complex_dim_guards_raise_as_jax(name):
    bad = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(ValueError, match="separate complex dim"):
        getattr(jfftc, name)(jnp.asarray(bad))
    with pytest.raises(ValueError, match="separate complex dim"):
        getattr(tfftc, name)(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="separate complex dim"):
        tfftc.complex_mul(torch.zeros(2, 2), torch.zeros(2, 3))


def test_zero_filled_recon_single_coil_with_a_mask_matches_jax():
    x = _pair(6, (3, 24, 20))
    mask = (np.random.RandomState(7).rand(1, 1, 20, 1) > 0.5).astype(np.float32)
    got = tmri.zero_filled_recon(torch.from_numpy(x), torch.from_numpy(mask), (16, 16))
    want = np.asarray(jmri.zero_filled_recon(jnp.asarray(x), jnp.asarray(mask), (16, 16)))
    assert got.shape == (3, 1, 16, 16) and got.is_contiguous() and want.shape == (3, 16, 16, 1)
    _close(got, want.transpose(0, 3, 1, 2))


def test_zero_filled_recon_multicoil_without_a_mask_matches_jax():
    x = _pair(8, (2, 4, 16, 16))
    got = tmri.zero_filled_recon(torch.from_numpy(x), None, (12, 12), multicoil=True)
    want = np.asarray(jmri.zero_filled_recon(jnp.asarray(x), None, (12, 12), multicoil=True))
    assert got.shape == (2, 1, 12, 12)
    _close(got, want.transpose(0, 3, 1, 2))


def test_zero_filled_recon_matches_the_host_transform():
    """The port's host ``UnetDataTransform`` on the same masked k-space."""
    rng = np.random.RandomState(9)
    mask_func = create_mask_for_mask_type("equispaced", [0.08], [4])
    host = UnetDataTransform("singlecoil", mask_func=None)
    pairs, images = [], []
    for i in range(3):
        kspace = (rng.randn(40, 32) + 1j * rng.randn(40, 32)).astype(np.complex64)
        masked, _ = apply_mask(to_real_pair(kspace), mask_func, (i, 1))
        image, *_ = host(masked, None, rng.rand(24, 24).astype(np.float32), {}, "f.h5", i)
        pairs.append(masked.astype(np.float32))
        images.append(image)
    got = tmri.zero_filled_recon(torch.from_numpy(np.stack(pairs)), None, (24, 24))
    np.testing.assert_allclose(got[:, 0].numpy(), np.stack(images), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("fn, shape, crop", [
    ("complex_center_crop", (8, 8, 2), (10, 4)), ("complex_center_crop", (8, 8, 2), (0, 4)),
    ("center_crop", (8, 8), (4, 10)), ("center_crop", (8, 8), (4, 0))])
def test_crop_guards_raise_as_jax(fn, shape, crop):
    with pytest.raises(ValueError):
        getattr(jmri, fn)(jnp.zeros(shape), crop)
    with pytest.raises(ValueError, match="invalid"):
        getattr(tmri, fn)(torch.zeros(shape), crop)


def test_crops_match_jax():
    x = _pair(10, (2, 9, 7))
    np.testing.assert_array_equal(tmri.complex_center_crop(torch.from_numpy(x), (4, 5)).numpy(),
                                  np.asarray(jmri.complex_center_crop(jnp.asarray(x), (4, 5))))
    y = x[..., 0]
    np.testing.assert_array_equal(tmri.center_crop(torch.from_numpy(y), (5, 3)).numpy(),
                                  np.asarray(jmri.center_crop(jnp.asarray(y), (5, 3))))
