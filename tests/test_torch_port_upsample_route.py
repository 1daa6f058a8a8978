"""Port parity: the decoder upsample routes as the JAX package's, and
``pool_backend`` is read as its ``pool2x2`` reads it.

- ``ops/resize.upsample2x_align_corners`` against the JAX package's
  ``upsample2x_align_corners(x, backend="xla")`` at shapes the TPU kernel
  does not take (``pallas_upsample_eligible`` false, among them up1's input
  at 320², W = 20) and under ``backend="xla"`` at shapes it takes: the
  forward and ``jax.vjp``'s input gradient bit for bit, 0 outputs apart, in
  f32 and bf16. Both sides compute the same per-axis lerps in the input's
  dtype, each bf16 operation rounded on its own; the backward is autograd's
  transpose of them on both sides.
- Where the shape is eligible and the backend is not "xla", the upsample is
  K1's autograd function (its plain version on the CPU).
- The port's copy of the eligibility rule equals the JAX package's over a
  grid of shapes.
- Any ``pool_backend`` builds: "pallas" takes K7, every other value the
  same pool.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu.ops import pallas_resize as jpr
from im2im_uq_tpu.ops import resize as jresize

from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.ops import pool as tpool
from im2im_uq_tpu_torch.ops import resize as tresize
from im2im_uq_tpu_torch.ops import upsample as tup
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = {"model": "UNet", "uncertainty_type": "quantiles"}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_and_port(shape, dtype: str, backend: str, seed: int):
    """(JAX output, JAX input gradient, port output, port input gradient) as
    f32 numpy NHWC arrays, for the same bf16- or f32-rounded x and g."""
    tdt, jdt = DTYPES[dtype]
    b, h, w, c = shape
    x = _x(shape, seed)
    g = _x((b, 2 * h, 2 * w, c), seed + 1)
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    want, vjp = jax.vjp(lambda t: jresize.upsample2x_align_corners(t, backend="xla"), xj)
    (want_dx,) = vjp(gj)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(tdt).requires_grad_()
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))).to(tdt)
    got = tresize.upsample2x_align_corners(xt, backend)
    got.backward(gt)

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    return (np.asarray(want.astype(jnp.float32)), np.asarray(want_dx.astype(jnp.float32)),
            nhwc(got), nhwc(xt.grad))


INELIGIBLE = [(1, 2, 2, 1), (2, 20, 20, 16), (2, 3, 5, 7), (1, 20, 20, 64), (2, 1, 1, 3),
              (1, 10, 16, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", INELIGIBLE)
def test_ineligible_shapes_take_the_xla_form_bit_for_bit(shape, dtype):
    assert not jpr.pallas_upsample_eligible(shape, DTYPES[dtype][1])
    want, want_dx, got, got_dx = _jax_and_port(shape, dtype, "auto", seed=3)
    assert got.shape == want.shape and got_dx.shape == want_dx.shape
    assert int((got != want).sum()) == 0
    assert int((got_dx != want_dx).sum()) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 8, 8, 256)])
def test_xla_backend_takes_the_xla_form_at_eligible_shapes(shape, dtype):
    assert jpr.pallas_upsample_eligible(shape, DTYPES[dtype][1])
    want, want_dx, got, got_dx = _jax_and_port(shape, dtype, "xla", seed=5)
    assert int((got != want).sum()) == 0
    assert int((got_dx != want_dx).sum()) == 0


def test_bf16_xla_form_differs_from_the_tpu_kernels_function():
    """The smallest case of the repaired fault: at (1, 2, 2, 1) the TPU
    kernel's bf16 function (K1's plain version) and the XLA form differ, and
    the port now gives the XLA form, as JAX does there."""
    x = torch.from_numpy(_x((1, 1, 2, 2))).to(torch.bfloat16)
    kernel_fn = tup.upsample2x_plain(x)
    routed = tresize.upsample2x_align_corners(x)
    assert torch.equal(routed, tresize.upsample2x_xla(x))
    assert int((routed != kernel_fn).sum()) > 0


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_eligible_shapes_take_k1_unless_xla(backend):
    x = torch.from_numpy(_x((2, 64, 16, 16))).requires_grad_()
    y = tresize.upsample2x_align_corners(x, backend)
    assert (type(y.grad_fn).__name__ == "Upsample2xBackward") == (backend != "xla")
    small = torch.from_numpy(_x((2, 64, 20, 20))).requires_grad_()
    assert type(tresize.upsample2x_align_corners(small, backend).grad_fn).__name__ != (
        "Upsample2xBackward")


def test_eligibility_copy_equals_jax():
    for b, h, w, c in itertools.product((1, 2), (1, 4, 6, 8, 10, 12, 16, 20, 40, 160),
                                        (1, 4, 8, 16, 20, 24, 40), (1, 8, 16, 24, 32, 64, 72,
                                                                    100, 128, 256, 512)):
        for tdt, jdt in (*DTYPES.values(), (torch.float64, jnp.float64),
                         (torch.float16, jnp.float16)):
            assert tup.pallas_upsample_eligible((b, h, w, c), tdt) == \
                jpr.pallas_upsample_eligible((b, h, w, c), jdt), (b, h, w, c, tdt)
    assert not tup.pallas_upsample_eligible((2, 16, 16), torch.float32)


def test_unet_routes_three_of_four_upsamples_to_k1(monkeypatch):
    """At 64² the decoder's inputs are 4², 8², 16² and 32² (512, 256, 128 and
    64 channels): up1's W = 4 is not eligible, the others are, as at 320²
    (W = 20 against 40, 80, 160)."""
    calls = []
    real = tresize.upsample2x
    monkeypatch.setattr(tresize, "upsample2x", lambda t: calls.append(t.shape) or real(t))
    state = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        state.model.eval()(torch.from_numpy(_x((1, 1, 64, 64))))
    assert [tuple(s) for s in calls] == [(1, 256, 8, 8), (1, 128, 16, 16), (1, 64, 32, 32)]
    calls.clear()
    cfg = dict(CFG, resize_backend="xla")
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        state.model.eval()(torch.from_numpy(_x((1, 1, 64, 64))))
    assert calls == []


@pytest.mark.parametrize("pool_backend", ["xla", "pallas", "cudnn", "auto"])
def test_any_pool_backend_builds_with_the_same_pool(pool_backend):
    cfg = dict(CFG, pool_backend=pool_backend)
    trunk = tasm.build_trunk(cfg)
    for i in range(1, 5):
        assert isinstance(getattr(trunk, f"down{i}").maxpool_conv[0], tpool.MaxPool2x2)
