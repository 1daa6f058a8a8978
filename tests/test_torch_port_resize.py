"""Port parity: K1's plain version and the general resize against the JAX package.

Inputs are NHWC numpy arrays from a seeded RandomState; the port takes them
as NCHW. Tolerances:

- against the Pallas kernel in interpret mode (as ``tests/test_pallas_resize.py``
  runs it): max abs error ≤ 1e-6·max|x|, because the Pallas kernel folds the
  W pass into an f32 matmul whose rounding differs from the lerp;
- against the JAX package's XLA formulation: bit-exact, the same lerps in
  the same order;
- against ``F.interpolate(..., align_corners=True)``: 1e-5·max|x|, an
  equivalent formula with its own weight rounding and summation order
  (a few f32 ulps apart; 1e-6·max|x| is exceeded at 40x48).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from im2im_uq_tpu.ops import pallas_resize as jpr
from im2im_uq_tpu.ops import resize as jresize

from im2im_uq_tpu_torch.ops import resize as tresize
from im2im_uq_tpu_torch.ops import upsample as tup
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)


def _x(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 20, 24, 128), (3, 10, 16, 64)])
def test_plain_matches_pallas_interpret(shape):
    x = _x(shape)
    assert jpr.pallas_upsample_eligible(shape, jnp.float32)
    want = np.asarray(jpr.upsample2x_pallas(jnp.asarray(x), True))
    got = _to_nhwc(tup.upsample2x_plain(_to_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(x).max()


@pytest.mark.parametrize(
    "shape", [(2, 1, 1, 3), (1, 1, 7, 2), (3, 5, 1, 1), (2, 9, 13, 5), (1, 33, 6, 4)]
)
def test_plain_matches_xla_formulation(shape):
    x = _x(shape, seed=1)
    want = np.asarray(jresize.upsample2x_align_corners(jnp.asarray(x), backend="xla"))
    got = _to_nhwc(tresize.upsample2x_align_corners(_to_nchw(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 3, 1, 1), (1, 4, 7, 9), (2, 64, 20, 24)])
def test_plain_matches_f_interpolate(shape):
    x = torch.from_numpy(_x(shape, seed=2))
    want = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    got = tup.upsample2x_plain(x)
    assert (got - want).abs().max().item() <= 1e-5 * x.abs().max().item()


def test_phase_weights_match_jax():
    for n in (1, 2, 3, 20, 160):
        for got, want in zip(tup.phase_weights(n), jpr._phase_weights(n)):
            np.testing.assert_array_equal(got, want)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


@pytest.mark.parametrize("shape", [(2, 4, 6, 5), (2, 3, 1, 1), (1, 5, 1, 7), (3, 7, 9, 1)])
def test_bf16_plain_rounds_once(shape):
    """The bf16 plain version is the TPU kernel's rounding, in the form the
    CUDA kernel computes it from its tables: each H-axis operation rounded
    to bf16 (zero rows past the edges), then per output column two W taps
    whose bf16 products are exact in f32, added once and rounded once."""
    x = torch.from_numpy(_x(shape, seed=3)).to(torch.bfloat16)
    got = tup.upsample2x_plain(x)
    assert got.dtype == torch.bfloat16
    h, w = shape[-2:]
    wh, ww = tup._bf16_tables(h, w, torch.device("cpu"))
    xf = x.float()
    zero = torch.zeros_like(xf[..., :1, :])
    m, p = torch.cat([zero, xf[..., :-1, :]], -2), torch.cat([xf[..., 1:, :], zero], -2)
    even = _bf16(m + _bf16(_bf16(xf - m) * wh[:h, None]))
    odd = _bf16(xf + _bf16(_bf16(p - xf) * wh[h:, None]))
    rows = torch.stack([even, odd], -2).flatten(-3, -2)
    left = rows[..., torch.clamp(torch.arange(w) - 1, min=0)]
    right = rows[..., torch.clamp(torch.arange(w) + 1, max=w - 1)]
    col_even = _bf16(ww[:w] * left + ww[w : 2 * w] * rows)
    col_odd = _bf16(ww[2 * w : 3 * w] * rows + ww[3 * w :] * right)
    want = torch.stack([col_even, col_odd], -1).flatten(-2).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "in_hw,out_hw", [((5, 7), (9, 4)), ((1, 1), (3, 3)), ((6, 4), (12, 5)), ((3, 5), (6, 10))]
)
def test_general_resize_matches_jax(in_hw, out_hw):
    x = _x((2, *in_hw, 3), seed=4)
    want = np.asarray(jresize.resize_bilinear_align_corners(jnp.asarray(x), out_hw))
    got = _to_nhwc(tresize.resize_bilinear_align_corners(_to_nchw(x), out_hw))
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_plain_version_and_other_devices_raise():
    before = tup.upsample2x.launches
    x = torch.from_numpy(_x((1, 2, 3, 4)))
    assert torch.equal(tup.upsample2x(x), tup.upsample2x_plain(x))
    assert tup.upsample2x.launches == before
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tup.upsample2x(torch.empty((1, 2, 3, 4), device="meta"))
