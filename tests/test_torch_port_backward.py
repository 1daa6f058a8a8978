"""Port parity: the upsample backward (K1b) and the max-pool backward (K7).

- ``upsample2x_bwd_plain`` against the JAX package's Pallas kernel
  ``_upsample2x_bwd_raw`` in interpret mode at shapes it takes, and against
  ``jax.vjp`` of the XLA formulation at odd shapes. Tolerance 4e-6·max|g|:
  each dx sums up to 16 taps whose weights add up to about 4, in another
  order than the JAX side's, so a few f32 ulps.
- ``Upsample2x`` (the autograd function) against autograd of
  ``upsample2x_plain``: the same tolerance (autograd sums the lerp's two
  products, g − g·f and g·f, where the transpose multiplies by 1 − f).
- ``max_pool2x2_bwd_plain`` against the Pallas ``_pool_bwd_raw`` in
  interpret mode, all-ties windows included, and against torch's autograd
  of ``F.max_pool2d`` at odd shapes: bit for bit, as it moves values only.
- The fault repaired with ``Upsample2x``: with a forward that, like the
  kernel, builds no graph, the upsample's output still carries
  ``Upsample2x``'s ``grad_fn``, and ``down4`` (which reaches the loss only
  through ``up1``'s upsample) gets a gradient.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from im2im_uq_tpu.ops import pallas_pool as jpp
from im2im_uq_tpu.ops import pallas_resize as jpr
from im2im_uq_tpu.ops import resize as jresize

from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.ops import pool as tpool
from im2im_uq_tpu_torch.ops import upsample as tup
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = {"model": "UNet", "uncertainty_type": "quantiles"}


def _x(shape, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _tol(g) -> float:
    return 4e-6 * float(np.abs(np.asarray(g)).max())


@pytest.mark.parametrize("shape", [(1, 8, 8, 64), (2, 10, 16, 128), (1, 20, 8, 64)])
def test_upsample_bwd_plain_matches_pallas_interpret(shape):
    b, h, w, c = shape
    assert jpr.pallas_upsample_eligible(shape, jnp.float32)
    g = _x((b, 2 * h, 2 * w, c), seed=1)
    want = np.asarray(jpr._upsample2x_bwd_raw(jnp.asarray(g), interpret=True))
    got = _to_nhwc(tup.upsample2x_bwd_plain(_to_nchw(g)))
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= _tol(g)


@pytest.mark.parametrize(
    "shape", [(2, 1, 1, 3), (1, 1, 7, 2), (3, 5, 1, 1), (2, 9, 13, 5), (1, 33, 6, 4)]
)
def test_upsample_bwd_plain_matches_jax_vjp_of_xla_formulation(shape):
    x = _x(shape, seed=2)
    b, h, w, c = shape
    g = _x((b, 2 * h, 2 * w, c), seed=3)
    _, vjp = jax.vjp(lambda t: jresize.upsample2x_align_corners(t, backend="xla"), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _to_nhwc(tup.upsample2x_bwd_plain(_to_nchw(g)))
    assert np.abs(got - want).max() <= _tol(g)


@pytest.mark.parametrize("shape", [(2, 3, 1, 1), (1, 5, 1, 7), (3, 7, 9, 1), (2, 4, 13, 17), (2, 8, 8, 8)])
def test_upsample_function_backward_matches_autograd_of_plain(shape):
    x = torch.from_numpy(_x(shape, seed=4))
    b, c, h, w = shape
    g = torch.from_numpy(_x((b, c, 2 * h, 2 * w), seed=5))
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    y1 = tup.upsample2x(x1)
    y1.backward(g)
    y2 = tup.upsample2x_plain(x2)
    y2.backward(g)
    assert torch.equal(y1.detach(), y2.detach())
    assert (x1.grad - x2.grad).abs().max().item() <= _tol(g)
    assert torch.equal(x1.grad, tup.upsample2x_bwd_plain(g))


def test_upsample_bwd_bf16_rounds_once():
    g = torch.from_numpy(_x((2, 3, 10, 14), seed=6)).bfloat16()
    got = tup.upsample2x_bwd_plain(g)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tup.upsample2x_bwd_plain(g.float()).bfloat16())


def test_transpose_weights_match_jax():
    for n in (1, 2, 5, 20, 160):
        fe, fo = jpr._phase_weights(n)
        a0, a1, a2, a3 = tup.transpose_weights(n)
        # pallas_resize.py:284-287
        np.testing.assert_array_equal(a0, np.concatenate([[0.0], fo[:-1]]).astype(np.float32))
        np.testing.assert_array_equal(a1, fe)
        np.testing.assert_array_equal(a2, 1.0 - fo)
        np.testing.assert_array_equal(a3, np.concatenate([1.0 - fe[1:], [0.0]]).astype(np.float32))


@pytest.mark.parametrize("kind", ["randn", "ties", "constant"])
def test_pool_bwd_plain_matches_pallas_interpret(kind):
    shape = (2, 8, 8, 128)
    rng = np.random.RandomState(7)
    if kind == "randn":
        x = rng.randn(*shape).astype(np.float32)
    elif kind == "ties":
        x = rng.randint(0, 3, shape).astype(np.float32)
    else:
        x = np.ones(shape, np.float32)
    assert jpp.pool_bwd_eligible(shape, jnp.float32)
    out = jpp._pool_fwd(jnp.asarray(x))
    g = rng.randn(*out.shape).astype(np.float32)
    want = np.asarray(jpp._pool_bwd_raw(jnp.asarray(x), out, jnp.asarray(g), interpret=True))
    got = _to_nhwc(tpool.max_pool2x2_bwd_plain(_to_nchw(x), _to_nchw(g)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 3, 2), (3, 4, 6, 8), (2, 2, 9, 4)])
def test_pool_bwd_plain_matches_torch_autograd(shape, dtype):
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    xr = x.clone().requires_grad_()
    y = F.max_pool2d(xr, 2)
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).to(dtype)
    y.backward(g)
    assert torch.equal(tpool.max_pool2x2_bwd_plain(x, g), xr.grad)
    xf = x.clone().requires_grad_()
    yf = tpool.max_pool2x2(xf)
    assert torch.equal(yf.detach(), y.detach())
    yf.backward(g)
    assert torch.equal(xf.grad, xr.grad)


def test_pool_without_a_window_gives_empty_output_and_zero_gradient():
    x = torch.from_numpy(_x((1, 2, 1, 9))).requires_grad_()
    y = tpool.max_pool2x2(x)
    assert y.shape == (1, 2, 0, 4)
    y.backward(torch.zeros_like(y))
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_cpu_wrappers_take_plain_versions_and_other_devices_raise():
    before = (tup.upsample2x_bwd.launches, tpool.max_pool2x2_bwd.launches)
    g = torch.from_numpy(_x((1, 2, 6, 8)))
    x = torch.from_numpy(_x((1, 2, 6, 8), seed=1))
    assert torch.equal(tup.upsample2x_bwd(g), tup.upsample2x_bwd_plain(g))
    assert torch.equal(tpool.max_pool2x2_bwd(x, g[..., :3, :4]),
                       tpool.max_pool2x2_bwd_plain(x, g[..., :3, :4]))
    assert (tup.upsample2x_bwd.launches, tpool.max_pool2x2_bwd.launches) == before
    meta = torch.empty((1, 2, 6, 8), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tup.upsample2x_bwd(meta)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tpool.max_pool2x2_bwd(meta, meta[..., :3, :4])


@pytest.mark.parametrize("pool_backend", ["xla", "pallas"])
def test_upsample_keeps_the_graph_and_down4_gets_a_gradient(pool_backend, monkeypatch):
    # K1f writes its output through data_ptr() into a fresh tensor, outside
    # autograd; the CPU's forward is made to do the same, so the graph can
    # only come from Upsample2x's own backward, as on the card
    monkeypatch.setattr(tup, "upsample2x_fwd", lambda t: tup.upsample2x_plain(t.detach()))
    x = torch.from_numpy(_x((1, 3, 4, 4))).requires_grad_()
    y = tup.upsample2x(x)
    assert type(y.grad_fn).__name__ == "Upsample2xBackward"
    g = torch.from_numpy(_x((1, 3, 8, 8), seed=3))
    y.backward(g)
    assert torch.equal(x.grad, tup.upsample2x_bwd_plain(g))
    cfg = dict(CFG, pool_backend=pool_backend)
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    model = state.model.train()
    out = model(torch.from_numpy(_x((2, 1, 32, 32), seed=9)))
    out.square().mean().backward()
    down4 = {n: p.grad for n, p in model.named_parameters() if n.startswith("baseModel.down4.")}
    assert len(down4) == 8
    for name, grad in down4.items():
        assert grad is not None and bool(torch.isfinite(grad).all()), name
        assert bool(grad.any()), name


def test_pool_backends_share_state_dict_keys_and_gradients():
    gen_states = []
    for backend in ("xla", "pallas"):
        cfg = dict(CFG, pool_backend=backend)
        gen_states.append(
            tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(1), device="cpu")
        )
    a, b = (s.model for s in gen_states)
    # both of the JAX package's values give the same pool, whose backward is K7
    for m in (a, b):
        for i in range(1, 5):
            assert isinstance(getattr(m.baseModel, f"down{i}").maxpool_conv[0], tpool.MaxPool2x2)
    assert a.state_dict().keys() == b.state_dict().keys()
    assert "baseModel.down1.maxpool_conv.1.double_conv.0.weight" in a.state_dict()
    x = torch.from_numpy(_x((2, 1, 24, 20), seed=10))
    for m in (a, b):
        m.train()(x).square().mean().backward()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_unknown_and_unported_backends_raise():
    # pool_backend is read as the JAX package's pool2x2 reads it: "pallas"
    # takes K7 and any other value the same pool, so "cudnn" builds
    trunk = tasm.build_trunk(dict(CFG, pool_backend="cudnn"))
    assert isinstance(trunk.down1.maxpool_conv[0], tpool.MaxPool2x2)
    with pytest.raises(ValueError, match="conv_backend"):
        tasm.build_trunk(dict(CFG, conv_backend="cudnn"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tasm.build_trunk(dict(CFG, bn_backend="barrier"))
