"""Port parity: the 3×3 conv kernels' plain versions (K3, K4, K5, K6) and
their autograd functions, against the JAX package.

- K3 / K4 forward: ``conv3x3_plain`` and ``conv3x3_bn_act_plain`` against
  the Pallas ``conv3x3_pallas_raw`` and ``_conv3x3_fused_raw`` in interpret
  mode at (2, 16, 16, 128→128), prologue and stats on and off, and against
  the JAX ``conv3x3`` / ``conv3x3_bn_act`` (their XLA fallbacks) at odd
  shapes: Cin 1, 3 and 64, H×W 1×1, 5×7 and 13×17. ``shift`` > 0
  throughout, so a prologue applied to the zero frame would show.
  Tolerance rtol = atol = 2e-5 on y, the JAX package's own
  (``tests/test_pallas_conv.py:54``); the stats take that file's stats
  tolerances (rtol 1e-4, atol 1e-3 on Σy and 1e-2 on Σy²,
  ``test_pallas_conv.py:134-139``).
- K5 / K6: ``wgrad3x3_plain`` and ``dgrad3x3_plain`` against the Pallas
  ``wgrad3x3_pallas_raw`` and ``dgrad3x3_pallas_raw`` in interpret mode at
  (2, 16, 16, 128, 128), prologue on and off; and the port's
  ``conv3x3_bn_act`` gradients (K5 and K6 plain versions behind the
  autograd function) against ``jax.grad`` of the JAX ``conv3x3_bn_act``
  through y and the stats, at Cin 64 and 128. Relative L2 error ≤ 1e-4 per
  tensor: f32 sums over B·H·W terms in another order.
- Dispatch: the CPU wrappers run the plain versions and count no launch; a
  meta tensor raises in every wrapper.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu.ops import pallas_conv as jpc
from im2im_uq_tpu.ops import pallas_conv_bwd as jpcb

from im2im_uq_tpu_torch.ops import conv as tconv
from im2im_uq_tpu_torch.ops import conv_bwd as tbwd
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

RTOL = ATOL = 2e-5
GRAD_REL_L2 = 1e-4
ODD_SHAPES = [  # (B, H, W, Cin, Cout)
    (2, 1, 1, 1, 8),
    (1, 5, 7, 3, 16),
    (2, 13, 17, 64, 24),
    (1, 13, 17, 1, 64),
    (2, 5, 7, 64, 64),
]


def _mk(b, h, w, cin, cout, seed):
    """x, HWIO kernel, bias, scale, shift (> 0) as numpy f32."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return (rng.randn(b, h, w, cin).astype(f32), (0.1 * rng.randn(3, 3, cin, cout)).astype(f32),
            (0.1 * rng.randn(cout)).astype(f32), (np.abs(rng.randn(cin)) + 0.5).astype(f32),
            (0.05 + 0.3 * np.abs(rng.randn(cin))).astype(f32))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _hwio(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(2, 3, 1, 0).numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_stats(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[:, 1].numpy(), want[:, 1], rtol=1e-4, atol=1e-2)


def _padded(a, w):
    """The frame the JAX backward kernels take: 1 row/col of zeros, W + 2
    rounded up to 8 (pallas_conv.py:442-445)."""
    wp = -(-(w + 2) // 8) * 8
    return jnp.pad(a, ((0, 0), (1, 1), (1, wp - w - 1), (0, 0)))


def test_k3_plain_matches_pallas_interpret():
    x, k, bias, _, _ = _mk(2, 16, 16, 128, 128, seed=0)
    want = jpc.conv3x3_pallas_raw(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                  interpret=True)
    got = tconv.conv3x3_plain(_nchw(x), _oihw(k), _t(bias))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("stats", [True, False])
def test_k4_plain_matches_pallas_interpret(prologue, stats):
    x, k, bias, scale, shift = _mk(2, 16, 16, 128, 128, seed=1)
    ps = jnp.stack([jnp.asarray(scale), jnp.asarray(shift)])
    want_y, want_st = jpc._conv3x3_fused_raw(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                             ps, prologue, stats, interpret=True)
    got_y, got_st = tconv.conv3x3_bn_act_plain(_nchw(x), _oihw(k), _t(bias), _t(scale),
                                               _t(shift), prologue, stats)
    np.testing.assert_allclose(_nhwc(got_y), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    if stats:
        _assert_stats(got_st, want_st)
    else:
        assert not got_st.any()


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_k3_plain_matches_jax_conv3x3_at_odd_shapes(shape):
    x, k, bias, _, _ = _mk(*shape, seed=2)
    want = jpc.conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    got = tconv.conv3x3_plain(_nchw(x), _oihw(k), _t(bias))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_k4_plain_matches_jax_conv3x3_bn_act_at_odd_shapes(shape, prologue):
    x, k, bias, scale, shift = _mk(*shape, seed=3)
    want_y, want_st = jpc.conv3x3_bn_act(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                         jnp.asarray(scale), jnp.asarray(shift), prologue, True)
    got_y, got_st = tconv.conv3x3_bn_act_plain(_nchw(x), _oihw(k), _t(bias), _t(scale),
                                               _t(shift), prologue, True)
    np.testing.assert_allclose(_nhwc(got_y), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    _assert_stats(got_st, want_st)


def test_k4_prologue_keeps_the_zero_frame():
    # a constant input with shift > 0: inside the image the prologue gives
    # relu(scale + shift) everywhere, outside it must stay 0, so the border
    # pixels see fewer nonzero taps than the centre
    x = torch.ones((1, 1, 3, 3))
    w = torch.ones((1, 1, 3, 3))
    y, _ = tconv.conv3x3_bn_act_plain(x, w, None, torch.ones(1), torch.ones(1), True, False)
    assert y[0, 0].tolist() == [[8.0, 12.0, 8.0], [12.0, 18.0, 12.0], [8.0, 12.0, 8.0]]


@pytest.mark.parametrize("prologue", [True, False])
def test_k5_plain_matches_pallas_interpret(prologue):
    b, h, w, cin, cout = 2, 16, 16, 128, 128
    x, _, _, scale, shift = _mk(b, h, w, cin, cout, seed=4)
    g = np.random.RandomState(5).randn(b, h, w, cout).astype(np.float32)
    want_dw, want_db = jpcb.wgrad3x3_pallas_raw(
        _padded(jnp.asarray(x), w), _padded(jnp.asarray(g), w), jnp.asarray(scale),
        jnp.asarray(shift), w=w, prologue=prologue, out_dtype=jnp.float32, interpret=True)
    got_dw, got_db = tbwd.wgrad3x3_plain(_nchw(x), _nchw(g), _t(scale), _t(shift), prologue)
    assert got_dw.shape == (cout, cin, 3, 3)
    assert _rel_l2(_hwio(got_dw), want_dw) <= GRAD_REL_L2
    assert _rel_l2(got_db.numpy(), want_db) <= GRAD_REL_L2


@pytest.mark.parametrize("prologue", [True, False])
def test_k6_plain_matches_pallas_interpret(prologue):
    b, h, w, cin, cout = 2, 16, 16, 128, 128
    x, k, _, scale, shift = _mk(b, h, w, cin, cout, seed=6)
    g = np.random.RandomState(7).randn(b, h, w, cout).astype(np.float32)
    want_dx, want_red = jpcb.dgrad3x3_pallas_raw(
        _padded(jnp.asarray(g), w), jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale),
        jnp.asarray(shift), prologue=prologue, interpret=True)
    got_dx, got_red = tbwd.dgrad3x3_plain(_nchw(g), _nchw(x), _oihw(k), _t(scale), _t(shift),
                                          prologue)
    assert _rel_l2(_nhwc(got_dx), want_dx) <= GRAD_REL_L2
    if prologue:
        for i in range(2):
            assert _rel_l2(got_red[i].numpy(), np.asarray(want_red)[i]) <= GRAD_REL_L2
    else:
        assert not got_red.any()


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("cin", [64, 128])
def test_fused_op_gradients_match_jax_grad(cin, prologue):
    b, h, w, cout = 2, 16, 16, 128
    x, k, bias, scale, shift = _mk(b, h, w, cin, cout, seed=11)
    rng = np.random.RandomState(12)
    wy = rng.randn(b, h, w, cout).astype(np.float32)
    ws = rng.randn(b, 2, cout).astype(np.float32)

    def loss(x, k, bias, scale, shift):
        y, st = jpc.conv3x3_bn_act(x, k, bias, scale, shift, prologue, True)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, k, bias, scale, shift)))
    ins = [t.requires_grad_() for t in (_nchw(x), _oihw(k), _t(bias), _t(scale), _t(shift))]
    y, st = tconv.conv3x3_bn_act(*ins, prologue=prologue, stats=True)
    ((y * _nchw(wy)).sum() + (st * _t(ws)).sum()).backward()
    got = [_nhwc(ins[0].grad), _hwio(ins[1].grad), ins[2].grad.numpy()]
    for name, g_, w_ in zip(["dx", "dw", "db"], got, want):
        assert _rel_l2(g_, w_) <= GRAD_REL_L2, name
    if prologue:
        for name, t, w_ in zip(["dscale", "dshift"], ins[3:], want[3:]):
            assert _rel_l2(t.grad.numpy(), w_) <= GRAD_REL_L2, name
    else:
        assert ins[3].grad is None and ins[4].grad is None


def test_k3_autograd_backward_matches_jax_conv3x3():
    b, h, w, cin, cout = 2, 13, 17, 64, 24
    x, k, bias, _, _ = _mk(b, h, w, cin, cout, seed=13)
    wy = np.random.RandomState(14).randn(b, h, w, cout).astype(np.float32)
    want = jax.grad(lambda x, k, b_: jnp.sum(jpc.conv3x3(x, k, b_) * wy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    ins = [t.requires_grad_() for t in (_nchw(x), _oihw(k), _t(bias))]
    (tconv.conv3x3(*ins) * _nchw(wy)).sum().backward()
    got = [_nhwc(ins[0].grad), _hwio(ins[1].grad), ins[2].grad.numpy()]
    for name, g_, w_ in zip(["dx", "dw", "db"], got, want):
        assert _rel_l2(g_, w_) <= GRAD_REL_L2, name


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    kernels = (tconv.conv3x3, tconv.conv3x3_bn_act, tbwd.wgrad3x3, tbwd.dgrad3x3)
    before = [k.launches for k in kernels]
    x, k, bias, scale, shift = (_t(a) for a in _mk(1, 5, 7, 3, 4, seed=15))
    x, k = _nchw(x.numpy()), _oihw(k.numpy())
    g = torch.from_numpy(np.random.RandomState(16).randn(1, 4, 5, 7).astype(np.float32))
    assert torch.equal(tconv.conv3x3_fwd(x, k, bias), tconv.conv3x3_plain(x, k, bias))
    for got, want in [
        (tconv.conv3x3_bn_act_fwd(x, k, bias, scale, shift, True, True),
         tconv.conv3x3_bn_act_plain(x, k, bias, scale, shift, True, True)),
        (tbwd.wgrad3x3(x, g, scale, shift, True), tbwd.wgrad3x3_plain(x, g, scale, shift, True)),
        (tbwd.dgrad3x3(g, x, k, scale, shift, True),
         tbwd.dgrad3x3_plain(g, x, k, scale, shift, True)),
    ]:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("wrapper", ["conv3x3", "conv3x3_bn_act", "wgrad3x3", "dgrad3x3"])
def test_wrappers_raise_on_other_devices(wrapper):
    x = torch.empty((1, 3, 5, 7), device="meta")
    k = torch.empty((4, 3, 3, 3), device="meta")
    g = torch.empty((1, 4, 5, 7), device="meta")
    c = torch.empty((3,), device="meta")
    call = {
        "conv3x3": lambda: tconv.conv3x3_fwd(x, k, None),
        "conv3x3_bn_act": lambda: tconv.conv3x3_bn_act_fwd(x, k, None, c, c, True, True),
        "wgrad3x3": lambda: tbwd.wgrad3x3(x, g, c, c, True),
        "dgrad3x3": lambda: tbwd.dgrad3x3(g, x, k, c, c, True),
    }[wrapper]
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        call()


def test_profile_buckets_put_the_port_kernels_first():
    from im2im_uq_tpu_torch.scripts import profile_step

    assert profile_step.bucket("void conv3x3_fwd_kernel<true, true>(...)") == "K3/K4 conv3x3 (port)"
    assert profile_step.bucket("void (anonymous namespace)::conv3x3_fwd_stem_kernel<false, true>(...)"
                               ) == "K3/K4 conv3x3 (port)"
    assert profile_step.bucket("void (anonymous namespace)::wgrad3x3_tc_kernel<false, true>(...)"
                               ) == "K5 wgrad3x3 (port)"
    assert profile_step.bucket("void (anonymous namespace)::dgrad3x3_tc_kernel<4, true>(...)"
                               ) == "K6 dgrad3x3 (port)"
    assert profile_step.bucket("sm90_xmma_wgrad_implicit_gemm_f32f32_tf32f32") == "conv (cuDNN)"
    assert profile_step.bucket("cudnn::detail::dgrad2d_alg1_1<float, 0, 6, 7, 5>") == "conv (cuDNN)"
    assert profile_step.bucket("sm90_xmma_fprop_implicit_gemm_f32f32") == "conv (cuDNN)"
    assert profile_step.bucket("void pointwise_mult_and_sum_complex<float2, 8, 4>") == "conv (cuDNN)"
    assert profile_step.bucket("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "batchnorm (cuDNN / torch)"
    from im2im_uq_tpu_torch.utils import profiling

    assert profiling.union_us([(0, 4), (2, 6), (8, 9), (8.5, 8.7)]) == 7


def test_gemm_stem_source_cuts_only_the_stem_dispatch():
    """``scripts/compare_conv_builds.py --gemm-stem`` times the shared GEMM
    at Cin = 1 by cutting ``conv3x3.cu``'s dispatch to the stem kernel out
    of a copy; the cut must find that one block and leave the GEMM's
    launch."""
    from im2im_uq_tpu_torch import _build
    from im2im_uq_tpu_torch.scripts import compare_conv_builds

    text = (_build.CSRC / "conv3x3.cu").read_text()
    cut = compare_conv_builds.gemm_stem_source(text)
    assert "conv3x3_fwd_stem_kernel<T, kPrologue, kStats><<<" in text
    assert "conv3x3_fwd_stem_kernel<T, kPrologue, kStats><<<" not in cut
    assert "return launch_grid(conv3x3_fwd_kernel<kPrologue, kStats>" in cut
    assert cut.count("{") == cut.count("}")
    with pytest.raises(ValueError, match="found 0"):
        compare_conv_builds.gemm_stem_source(cut)
