"""Port parity in bfloat16 (``compute_dtype: bfloat16``) against the JAX package.

Inputs are numpy arrays from seeded RandomStates, handed to both sides.

- K1f: the bf16 plain version equals the Pallas ``_upsample2x_fwd_raw`` in
  interpret mode bit for bit at shapes that pass ``pallas_upsample_eligible``
  (W % 8 == 0, C ≥ 64 so that the lane pad is at most 2x): per-operation bf16 H lerps, then the W axis as an f32 product
  with the bf16 entries of ``_col_transpose_matrix``, rounded once. The
  port's copy of that matrix equals the original.
- K1b: the bf16 plain version within one bf16 ulp of ``_upsample2x_bwd_raw``
  (interpret): both sum in f32, in another order, and round once.
- K7: the bf16 plain version equals ``_pool_bwd_raw`` (interpret) exactly on
  tied windows (first max in row-major order), all-equal and random ones.
- K3 and K4: the bf16 plain versions against ``conv3x3_pallas_raw`` and
  ``_conv3x3_fused_raw`` (interpret) at (2, 16, 16, 128→128), which their
  asserts take (Cin % 128 == 0, a row tile dividing H): y within
  ``conv_probe.bf16_tolerance`` (one bf16 ulp plus the f32 sums' order
  term) plus, with the prologue, the conv of the activations that the two
  sides round to different bf16 values (XLA contracts the prologue's
  x·scale + shift into an FMA on the CPU, the port does not); the stats
  within the f32 bars of ``test_torch_port_conv.py`` plus what y's bar
  lets Σy and Σy² move (Σ bar and Σ bar·(2|y| + bar) per image and
  channel): both sides take the stats over their own rounded y, so an
  output one ulp apart moves them by its ulp.
- K5 and K6: the bf16 plain versions against ``wgrad3x3_pallas_raw`` and
  ``dgrad3x3_pallas_raw`` (interpret) on bf16 inputs at (2, 16, 16,
  128→128), prologue on and off. Both sum exact bf16 × bf16 products in
  f32, in other orders: dW, db and the reductions within 2·K·2^-24 of the
  sums of the magnitudes (K the terms of each sum), dx within one bf16 ulp
  plus that term times the scale; plus, where the two sides round K5's
  activation or decide K6's mask differently (XLA contracts x·scale +
  shift into an FMA, the port does not), the products of those elements.
- The bf16 ``conv3x3_bn_act`` gradients (K5/K6 plain versions behind the
  autograd function) against ``jax.grad`` of the JAX op in bf16 (its
  Pallas backward in interpret mode) at Cin 64 and 128: within 1e-3
  relative L2 per tensor (measured at most 7.2e-5: both round y, g_tot and
  the gradients to bf16, and their f32 sums round apart at a few
  elements), and no farther from the same op's f64 gradients (the port's,
  in f64) than 1.25 times the JAX package's bf16 gradients plus 1e-5
  (measured: equal to three digits, 1.9e-3 to 3.3e-3).
- ``resolve_dtype`` as the JAX package's, for the names it takes and
  refuses; ``build_trunk`` / ``add_uncertainty`` take bf16 for UNet and WNet
  under every conv backend; ``train_net`` trains a bf16 model under
  ``pallas_fused`` for an epoch.
- The UNet + quantile head at 128², batch 2 (the smallest UNet whose four
  decoder upsamples all pass ``pallas_upsample_eligible``, so that the JAX
  side runs the TPU kernel's K1f, ``resize_backend: "pallas"``), on the
  same JAX weights and randomised running statistics loaded with
  ``strict=True``, in bf16 under the port's ``xla``, ``pallas`` and
  ``pallas_fused`` backends against the JAX package in bf16 (``xla``
  convs): the eval forward within 1e-2 relative L2; one train step under
  each backend with the loss within 2e-3, the whole gradient within 3e-1 relative L2 and every running statistic within 5e-3 (bf16
  rounding through 20 layers, and ReLU masks that flip on it; measured
  3.2e-3, 4e-4, 1.8e-1 and 1.6e-3). The tripwire: against the JAX package
  in f64, the port's bf16 error in the eval output, the whole gradient and
  the worst running statistic is at most twice the JAX package's own bf16
  error (as ``test_torch_port_fused.py`` holds f32 to f64).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.ops import pallas_conv as jpc
from im2im_uq_tpu.ops import pallas_conv_bwd as jpcb
from im2im_uq_tpu.ops import pallas_pool as jpp
from im2im_uq_tpu.ops import pallas_resize as jpr
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables, state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.ops import conv as tconv
from im2im_uq_tpu_torch.ops import conv_bwd as tbwd
from im2im_uq_tpu_torch.ops import conv_probe as tprobe
from im2im_uq_tpu_torch.ops import pool as tpool
from im2im_uq_tpu_torch.ops import upsample as tup
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16


def _bf16_np(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    """An f32 numpy array of bf16 values (the same inputs for both sides)."""
    a = scale * np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _nchw(a: np.ndarray, dtype=BF16) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jbf16(a: np.ndarray) -> jax.Array:
    return jnp.asarray(a, jnp.bfloat16)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 10, 24, 128), (2, 8, 8, 64),
                                   (1, 20, 16, 128)])
def test_k1f_bf16_plain_is_the_tpu_kernels_function(shape):
    assert jpr.pallas_upsample_eligible(shape, jnp.bfloat16)
    x = _bf16_np(shape, seed=0)
    want = _f32(jpr._upsample2x_fwd_raw(_jbf16(x), interpret=True))
    got = tup.upsample2x_plain(_nchw(x))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("w", [1, 2, 5, 8, 20, 160])
def test_col_transpose_matrix_is_the_jax_packages(w):
    np.testing.assert_array_equal(tup.col_transpose_matrix(w), jpr._col_transpose_matrix(w))


@pytest.mark.parametrize("shape", [(1, 8, 8, 64), (2, 10, 16, 128)])
def test_k1b_bf16_plain_within_one_ulp_of_pallas_interpret(shape):
    b, h, w, c = shape  # the forward's input; the cotangent is twice its size
    g = _bf16_np((b, 2 * h, 2 * w, c), seed=1)
    want = _f32(jpr._upsample2x_bwd_raw(_jbf16(g), interpret=True))
    got = _nhwc(tup.upsample2x_bwd_plain(_nchw(g)))
    ulp = _nhwc(tprobe.bf16_ulp(torch.from_numpy(np.moveaxis(want, -1, 1).copy())))
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("kind", ["ties", "constant", "randn"])
def test_k7_bf16_plain_equals_pallas_interpret_on_tied_windows(kind):
    shape = (2, 8, 8, 128)
    rng = np.random.RandomState(7)
    if kind == "ties":  # three values: most windows hold a tie of their max
        x = rng.randint(0, 3, shape).astype(np.float32)
    elif kind == "constant":
        x = np.ones(shape, np.float32)
    else:
        x = _bf16_np(shape, seed=8)
    assert jpp.pool_bwd_eligible(shape, jnp.bfloat16)
    out = jpp._pool_fwd(_jbf16(x))
    g = _bf16_np(out.shape, seed=9)
    want = _f32(jpp._pool_bwd_raw(_jbf16(x), out, _jbf16(g), interpret=True))
    got = tpool.max_pool2x2_bwd_plain(_nchw(x), _nchw(g))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_nhwc(got), want)


def _conv_inputs(seed: int):
    """x, HWIO kernel and bias as bf16 values; scale, shift (> 0) f32."""
    rng = np.random.RandomState(seed)
    x = _bf16_np((2, 16, 16, 128), seed)
    k = _bf16_np((3, 3, 128, 128), seed + 1, scale=0.03)
    bias = _bf16_np((128,), seed + 2, scale=0.1)
    scale = (np.abs(rng.randn(128)) + 0.5).astype(np.float32)
    shift = (0.05 + 0.3 * np.abs(rng.randn(128))).astype(np.float32)
    return x, k, bias, scale, shift


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(BF16)


def _bf16_bar(want: np.ndarray, a: np.ndarray, k: np.ndarray,
              a_other: np.ndarray | None = None) -> np.ndarray:
    """The per-output bar of a bf16 conv against ``want``: ``bf16_tolerance``
    of the activation ``a`` and kernel ``k``, plus, where the other side
    rounded its activation ``a_other`` differently, the conv of that
    difference's magnitude."""
    bar = tprobe.bf16_tolerance(torch.from_numpy(a), torch.from_numpy(k),
                                torch.from_numpy(want)).numpy()
    if a_other is not None:
        flips = _nchw(np.abs(a_other - a), torch.float32)
        bar = bar + _nhwc(tconv.conv3x3_plain(flips, _oihw(np.abs(k)).float()))
    return bar


def test_k3_bf16_plain_matches_pallas_interpret():
    x, k, bias, _, _ = _conv_inputs(seed=0)
    want = _f32(jpc.conv3x3_pallas_raw(_jbf16(x), _jbf16(k), _jbf16(bias), interpret=True))
    got = tconv.conv3x3_plain(_nchw(x), _oihw(k), torch.from_numpy(bias).to(BF16))
    assert got.dtype == BF16
    assert (np.abs(_nhwc(got) - want) <= _bf16_bar(want, x, k)).all()


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("stats", [True, False])
def test_k4_bf16_plain_matches_pallas_interpret(prologue, stats):
    x, k, bias, scale, shift = _conv_inputs(seed=3)
    ps = jnp.stack([jnp.asarray(scale), jnp.asarray(shift)])
    want_y, want_st = jpc._conv3x3_fused_raw(_jbf16(x), _jbf16(k), _jbf16(bias), ps,
                                             prologue, stats, interpret=True)
    got_y, got_st = tconv.conv3x3_bn_act_plain(
        _nchw(x), _oihw(k), torch.from_numpy(bias).to(BF16), torch.from_numpy(scale),
        torch.from_numpy(shift), prologue, stats)
    assert got_y.dtype == BF16 and got_st.dtype == torch.float32
    a = _nhwc(tbwd.prologue_activation(_nchw(x, torch.float32), torch.from_numpy(scale),
                                       torch.from_numpy(shift), prologue).to(BF16))
    # XLA contracts the prologue's x·scale + shift into an FMA on the CPU;
    # the port rounds the product first, so an activation at a bf16
    # rounding boundary may round the other way (2 of 65,536 here)
    a_jax = (_f32(jax.jit(lambda v, sc, sh: jnp.maximum(
        v.astype(jnp.float32) * sc + sh, 0.0).astype(jnp.bfloat16))(
            _jbf16(x), jnp.asarray(scale), jnp.asarray(shift)))
        if prologue else a)
    want_y = _f32(want_y)
    bar = _bf16_bar(want_y, a, k, a_jax)
    assert (np.abs(_nhwc(got_y) - want_y) <= bar).all()
    if stats:
        # the f32 bars, plus what y's bar allows the sums of y and y² to move
        want_st = np.asarray(want_st)
        bar_s = bar.sum((1, 2))
        bar_q = (bar * (2 * np.abs(want_y) + bar)).sum((1, 2))
        assert (np.abs(got_st[:, 0].numpy() - want_st[:, 0])
                <= 1e-3 + 1e-4 * np.abs(want_st[:, 0]) + bar_s).all()
        assert (np.abs(got_st[:, 1].numpy() - want_st[:, 1])
                <= 1e-2 + 1e-4 * np.abs(want_st[:, 1]) + bar_q).all()
    else:
        assert not got_st.any()


def _padded(a, w):
    """The frame the JAX backward kernels take: 1 row/col of zeros, W + 2
    rounded up to 8 (pallas_conv.py:442-445)."""
    wp = -(-(w + 2) // 8) * 8
    return jnp.pad(a, ((0, 0), (1, 1), (1, wp - w - 1), (0, 0)))


def _order_term(terms: int, mass: torch.Tensor) -> torch.Tensor:
    """The worst-case difference of two f32 sums of ``terms`` exact products
    in different orders, whose magnitudes sum to ``mass``."""
    return 2.0 * terms * 2.0**-24 * mass


def _jax_prologue(x: np.ndarray, scale, shift):
    """x·scale + shift as XLA computes it on the CPU (an FMA), NHWC f32."""
    return _f32(jax.jit(lambda v, sc, sh: v.astype(jnp.float32) * sc + sh)(
        _jbf16(x), jnp.asarray(scale), jnp.asarray(shift)))


@pytest.mark.parametrize("prologue", [True, False])
def test_k5_bf16_plain_matches_pallas_interpret(prologue):
    x, _, _, scale, shift = _conv_inputs(seed=20)
    g = _bf16_np(x.shape, seed=22)
    want_dw, want_db = jpcb.wgrad3x3_pallas_raw(
        _padded(_jbf16(x), 16), _padded(_jbf16(g), 16), jnp.asarray(scale),
        jnp.asarray(shift), w=16, prologue=prologue, out_dtype=jnp.float32, interpret=True)
    sc, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    got_dw, got_db = tbwd.wgrad3x3_plain(_nchw(x), _nchw(g), sc, sh, prologue)
    assert got_dw.dtype == got_db.dtype == torch.float32
    a = tbwd.prologue_activation(_nchw(x, torch.float32), sc, sh, prologue).to(BF16).float()
    a_jax = (_nchw(np.maximum(_jax_prologue(x, scale, shift), 0.0), BF16).float()
             if prologue else a)
    gf = _nchw(g, torch.float32)
    terms = x.shape[0] * 16 * 16
    bar = (_order_term(terms, tbwd.wgrad3x3_plain(a.abs(), gf.abs(), None, None, False)[0])
           + tbwd.wgrad3x3_plain((a - a_jax).abs(), gf.abs(), None, None, False)[0])
    got = got_dw.permute(2, 3, 1, 0).numpy()
    assert (np.abs(got - np.asarray(want_dw)) <= bar.permute(2, 3, 1, 0).numpy()).all()
    db_bar = _order_term(terms, gf.abs().sum((0, 2, 3))).numpy()
    assert (np.abs(got_db.numpy() - np.asarray(want_db)) <= db_bar).all()


@pytest.mark.parametrize("prologue", [True, False])
def test_k6_bf16_plain_matches_pallas_interpret(prologue):
    x, k, _, scale, shift = _conv_inputs(seed=24)
    g = _bf16_np(x.shape, seed=26)
    want_dx, want_red = jpcb.dgrad3x3_pallas_raw(
        _padded(_jbf16(g), 16), _jbf16(x), _jbf16(k), jnp.asarray(scale), jnp.asarray(shift),
        prologue=prologue, interpret=True)
    sc, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    got_dx, got_red = tbwd.dgrad3x3_plain(_nchw(g), _nchw(x), _oihw(k), sc, sh, prologue)
    assert got_dx.dtype == BF16 and got_red.dtype == torch.float32
    gf, xf, kf = _nchw(g, torch.float32), _nchw(x, torch.float32), _oihw(k).float()
    da = tbwd.dgrad3x3_plain(gf, xf, kf, None, None, False)[0]
    ot = _order_term(9 * k.shape[-1], tbwd.dgrad3x3_plain(gf.abs(), xf, kf.abs(), None, None,
                                                          False)[0])
    want_dx = _f32(want_dx)
    if not prologue:
        bar = tprobe.bf16_ulp(torch.from_numpy(want_dx)).numpy() + _nhwc(ot)
        assert (np.abs(_nhwc(got_dx) - want_dx) <= bar).all()
        assert not got_red.any()
        return
    mask = xf * sc[:, None, None] + sh[:, None, None] > 0
    flips = (mask != _nchw(_jax_prologue(x, scale, shift) > 0, torch.bool)).float()
    assert flips.sum() <= 5
    # dx and dam: the order term, and da itself where the masks differ
    dam_bar = mask.float() * ot + flips * da.abs()
    bar = (tprobe.bf16_ulp(torch.from_numpy(want_dx)).numpy()
           + _nhwc(dam_bar * sc[:, None, None]))
    assert (np.abs(_nhwc(got_dx) - want_dx) <= bar).all()
    terms = x.shape[0] * 16 * 16
    dam = da * mask
    red_bar = torch.stack([(dam_bar * xf.abs()).sum((0, 2, 3))
                           + _order_term(terms, (dam * xf).abs().sum((0, 2, 3))),
                           dam_bar.sum((0, 2, 3))
                           + _order_term(terms, dam.abs().sum((0, 2, 3)))])
    assert ((got_red - torch.from_numpy(np.asarray(want_red))).abs() <= red_bar).all()


@pytest.mark.parametrize("cin", [64, 128])
def test_fused_op_bf16_gradients_match_jax_grad(cin):
    rng = np.random.RandomState(30 + cin)
    x = _bf16_np((2, 16, 16, cin), 31)
    k = _bf16_np((3, 3, cin, 128), 32, scale=0.05)
    bias = _bf16_np((128,), 33, scale=0.1)
    scale = (np.abs(rng.randn(cin)) + 0.5).astype(np.float32)
    shift = (0.05 + 0.3 * rng.randn(cin)).astype(np.float32)
    wy = rng.randn(2, 16, 16, 128).astype(np.float32)
    ws = (0.01 * rng.randn(2, 2, 128)).astype(np.float32)

    def jax_grads(dtype):
        def loss(x, k, bias, scale, shift):
            y, st = jpc.conv3x3_bn_act(x, k, bias, scale, shift, True, True)
            return jnp.sum(y.astype(jnp.float32) * wy) + jnp.sum(st * ws)

        args = [jnp.asarray(a, dtype) for a in (x, k, bias)]
        args += [jnp.asarray(a) for a in (scale, shift)]
        return [_f32(gr) for gr in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]

    want = jax_grads(jnp.bfloat16)

    def port_grads(dtype, wide):
        ins = [_nchw(x, dtype).requires_grad_(), _oihw(k).to(dtype).requires_grad_(),
               torch.from_numpy(bias).to(dtype).requires_grad_(),
               torch.from_numpy(scale).to(wide).requires_grad_(),
               torch.from_numpy(shift).to(wide).requires_grad_()]
        y, st = tconv.conv3x3_bn_act(*ins, prologue=True, stats=True)
        ((y.to(wide) * _nchw(wy, wide)).sum() + (st * torch.from_numpy(ws).to(wide)).sum()
         ).backward()
        assert [t.grad.dtype for t in ins] == [dtype] * 3 + [wide] * 2
        return [_nhwc(ins[0].grad.double()), ins[1].grad.double().permute(2, 3, 1, 0).numpy(),
                ins[2].grad.double().numpy(), ins[3].grad.double().numpy(),
                ins[4].grad.double().numpy()]

    # the f64 reference: the same op in f64 (the JAX fused op does not run
    # in f64; the port's f32 form is held to it by test_torch_port_conv.py)
    f64 = port_grads(torch.float64, torch.float64)
    got = port_grads(BF16, torch.float32)
    for name, g_, w_, r_ in zip(["dx", "dw", "db", "dscale", "dshift"], got, want, f64):
        assert _rel_l2(g_, w_) < 1e-3, (name, _rel_l2(g_, w_))
        assert _rel_l2(g_, r_) <= 1.25 * _rel_l2(w_, r_) + 1e-5, (name, _rel_l2(g_, r_),
                                                                  _rel_l2(w_, r_))


# ------------------------------------------------------------ the config

CFG = dict(
    DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
    conv_backend="xla", lane_pack=False, dataset="synthetic", batch_size=2, lr=1e-3,
)


@pytest.mark.parametrize(
    "name", [None, "float32", "f32", "bfloat16", "bf16", "float16", "fp16", "bogus"])
def test_resolve_dtype_is_the_jax_packages(name):
    cfg = {} if name is None else {"compute_dtype": name}
    try:
        want = jasm.resolve_dtype(cfg)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            tasm.resolve_dtype(cfg)
        with pytest.raises(ValueError, match="unknown compute_dtype"):
            tasm.build_trunk(dict(CFG, compute_dtype=name))
        return
    got = tasm.resolve_dtype(cfg)
    assert got == {None: torch.float32, jnp.bfloat16: BF16}[want]
    assert tasm.resolve_dtype(cfg, BF16) == BF16


@pytest.mark.parametrize("model", ["UNet", "WNet"])
@pytest.mark.parametrize("conv_backend", ["xla", "pallas", "pallas_fused"])
def test_bf16_models_build_and_serve_under_every_backend(model, conv_backend):
    cfg = dict(CFG, model=model, conv_backend=conv_backend, compute_dtype="bf16")
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    trunk, head = state.model.baseModel, state.model.last_layer
    assert trunk.dtype == head.dtype == BF16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 2 if model == "WNet" else 1, 16, 16)
                         .astype(np.float32))
    out = state.forward(x)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 1, 16, 16)
    assert torch.isfinite(out).all()


def test_train_net_trains_pallas_fused_in_bf16():
    """An epoch of ``train_net`` (4 steps at batch 2, 16², validation) under
    ``pallas_fused`` in bf16: finite losses, every parameter moved, f32
    parameters, the running statistics moved once a step."""
    cfg = dict(CFG, conv_backend="pallas_fused", compute_dtype="bfloat16", resize_backend="auto")
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    records = []
    log = type("Log", (), {"log": lambda self, r: records.append(dict(r))})()
    ds = SyntheticDataset(num_examples=8, image_size=16, seed=30)
    ttrain.train_net(state, ds, ds, None, epochs=1, batch_size=2, lr=1e-3, validate_every=1,
                     config=cfg, logger=log)
    epoch = {k: v for r in records for k, v in r.items()}
    assert epoch["iter"] == 4 and np.isfinite([epoch["train_loss"], epoch["val_loss"]]).all()
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), n
        assert not torch.equal(p, before[n]), n
    tracked = [int(b) for n, b in state.model.named_buffers() if "num_batches" in n]
    assert tracked and set(tracked) == {4}


# ------------------------------------------------------------ whole model

SIDE, BATCH = 128, 2
EVAL_BAR, LOSS_BAR, GRAD_BAR, STAT_BAR = 1e-2, 2e-3, 3e-1, 5e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _randomise_stats(stats, rng: np.random.RandomState):
    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _jax_run(cfg: dict, variables: dict, batch, dtype) -> dict:
    """The JAX package's eval output, and one train step's loss, gradients
    and running statistics as the port's state-dict names, in f64."""
    model = jasm.add_uncertainty(jasm.build_trunk(cfg), cfg).model
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
    out = model.apply(v, jnp.asarray(batch[0], dtype), train=False)
    tx = optax.adam(cfg["lr"])
    step = jax.jit(jtrain._train_step_body(model, jheads.head_loss_pe_fn("quantiles"), cfg, tx))
    state = jtrain.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    state, loss, grads = step(state, *(jnp.asarray(a, dtype) for a in batch))
    sd = state_dict_from_jax({"params": _np(grads), "batch_stats": _np(state.batch_stats)},
                             "UNet", "quantiles")
    return {"eval": np.asarray(out, np.float64), "loss": float(loss),
            "step": {n: t.double() for n, t in sd.items()}}


@pytest.fixture(scope="module")
def reference():
    """One JAX init at 128² with randomised running statistics, the batch,
    and the JAX package's bf16 (Pallas K1f in interpret mode) and f64 runs."""
    jstate = jasm.add_uncertainty(jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
                                  example_input=jnp.zeros((BATCH, SIDE, SIDE, 1)))
    v = _np(dict(jstate.variables))
    v = {"params": v["params"],
         "batch_stats": _randomise_stats(v["batch_stats"], np.random.RandomState(1))}
    ds = SyntheticDataset(num_examples=BATCH, image_size=SIDE, seed=21)
    batch = (np.stack([ds[i][0] for i in range(BATCH)]),
             np.stack([ds[i][1] for i in range(BATCH)]), np.ones((BATCH,), np.float32))
    for c, side in zip((512, 256, 128, 64), (8, 16, 32, 64)):
        assert jpr.pallas_upsample_eligible((BATCH, side, side, c), jnp.bfloat16)
    bf16 = _jax_run(dict(CFG, compute_dtype="bfloat16", resize_backend="pallas"), v, batch,
                    jnp.float32)
    with jax.enable_x64(True):
        f64 = _jax_run(CFG, v, batch, jnp.float64)
    return {"variables": v, "batch": batch, "bf16": bf16, "f64": f64}


def _port_state(conv_backend: str, ref: dict) -> tasm.UQState:
    """The port's bf16 model under ``conv_backend`` with the JAX weights."""
    cfg = dict(CFG, conv_backend=conv_backend, compute_dtype="bfloat16")
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    load_jax_variables(state.model, ref["variables"], "UNet", "quantiles")
    return state


@pytest.mark.parametrize("conv_backend", ["xla", "pallas", "pallas_fused"])
def test_bf16_eval_forward_matches_jax_bf16(conv_backend, reference):
    state = _port_state(conv_backend, reference)
    x = torch.from_numpy(np.ascontiguousarray(reference["batch"][0].transpose(0, 3, 1, 2)))
    got = state.forward(x).permute(0, 1, 3, 4, 2).double().numpy()
    want, f64 = reference["bf16"]["eval"], reference["f64"]["eval"]
    assert got.shape == want.shape == (BATCH, 3, SIDE, SIDE, 1)
    assert _rel_l2(got, want) < EVAL_BAR
    assert _rel_l2(got, f64) <= 2 * _rel_l2(want, f64)


@pytest.fixture(scope="module", params=["xla", "pallas", "pallas_fused"])
def port_step(request, reference):
    """One bf16 ``make_train_step`` of the port: loss, gradients, running
    statistics."""
    state = _port_state(request.param, reference)
    cfg = state.params
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = ttrain.make_train_step(state.model, theads.head_loss_pe_fn("quantiles"), cfg, opt)
    loss = float(step(*ttrain.put_batch(*reference["batch"], torch.device("cpu"))))
    out = {n: p.grad.double() for n, p in state.model.named_parameters()}
    out.update({n: b.double() for n, b in state.model.named_buffers() if "running" in n})
    return {"loss": loss, "step": out}


def _tree_err(got: dict, want: dict, names) -> float:
    num = sum(float((got[n] - want[n]).square().sum()) for n in names)
    return (num / sum(float(want[n].square().sum()) for n in names)) ** 0.5


def test_bf16_train_step_matches_jax_bf16(port_step, reference):
    got = port_step
    want, f64 = reference["bf16"], reference["f64"]
    params = [n for n in got["step"] if "running" not in n]
    stats = [n for n in got["step"] if "running" in n]
    assert len(params) == 80 and len(stats) == 36
    assert abs(got["loss"] - want["loss"]) <= LOSS_BAR * abs(want["loss"])
    assert _tree_err(got["step"], want["step"], params) < GRAD_BAR
    assert (_tree_err(got["step"], f64["step"], params)
            <= 2 * _tree_err(want["step"], f64["step"], params))
    for n in stats:
        assert _rel_l2(got["step"][n], want["step"][n]) < STAT_BAR, n
    worst = max(_rel_l2(got["step"][n], f64["step"][n]) for n in stats)
    assert worst <= 2 * max(_rel_l2(want["step"][n], f64["step"][n]) for n in stats)


def test_chip_smoke_bf16_conv_sites_are_the_models_launches(monkeypatch):
    """A bf16 train step under ``pallas``, a bf16 eval forward under
    ``pallas_fused`` and a bf16 train step under ``pallas_fused`` of the
    port's UNet at 32² (a tenth of 320²), batch 2, call the K3/K4 wrappers
    (the first two) and the K5/K6 wrappers (the last) in bf16 at the
    channel counts, prologues and sides (a tenth) of
    ``chip_smoke.bf16_conv_sites``, as often."""
    import collections

    import chip_smoke

    calls: collections.Counter = collections.Counter()

    def record(module, name, path, kernels, shape_of):
        fn = getattr(module, name)

        def wrapper(*args):
            if path[1] == kernels:
                assert args[0].dtype == BF16
                calls[name, path[0], shape_of(*args)] += 1
            return fn(*args)

        monkeypatch.setattr(module, name, wrapper)

    path = ["pallas", "fwd"]
    record(tconv, "conv3x3_fwd", path, "fwd", lambda x, w, b: ((*x.shape, w.shape[0]), False))
    record(tconv, "conv3x3_bn_act_fwd", path, "fwd",
           lambda x, w, b, sc, sh, p, st: ((*x.shape, w.shape[0]), p))
    record(tbwd, "wgrad3x3_nhwc", path, "bwd", lambda x, gp, co, sc, sh, p: ((*x.shape, co), p))
    record(tbwd, "dgrad3x3_nhwc", path, "bwd",
           lambda gp, x, w, sc, sh, p: ((*x.shape, w.shape[0]), p))
    x = torch.randn(2, 1, 32, 32)
    for backend, kernels, train in (("pallas", "fwd", True), ("pallas_fused", "fwd", False),
                                    ("pallas_fused", "bwd", True)):
        path[:] = [backend, kernels]
        cfg = dict(CFG, conv_backend=backend, compute_dtype="bf16")
        state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                     generator=torch.Generator().manual_seed(0), device="cpu")
        if train:
            state.model.train()(x).square().mean().backward()
        else:
            state.forward(x)

    names = {"conv3x3_bf16": "conv3x3_fwd", "conv3x3_bn_act_bf16": "conv3x3_bn_act_fwd",
             "wgrad3x3_bf16": "wgrad3x3_nhwc", "dgrad3x3_bf16": "dgrad3x3_nhwc"}
    want: collections.Counter = collections.Counter()
    for kernel, paths in chip_smoke.bf16_conv_sites().items():
        for backend, sites in paths.items():
            for ((_, cin, h, w, cout), prologue), n in sites.items():
                want[names[kernel], backend, ((2, cin, h // 10, w // 10, cout), prologue)] += n
    assert calls == want
    assert sum(want.values()) == 22 + 8 + 14 + 14 + 13


def test_profile_step_profiles_each_backend_in_bf16_and_buckets_its_kernels():
    from im2im_uq_tpu_torch.scripts import profile_step

    assert profile_step.CASES == [(b, d) for d in ("float32", "bfloat16")
                                  for b in ("xla", "pallas", "pallas_fused")]
    for name in ("void (anonymous namespace)::k5::wgrad_kernel(CUtensorMap_st, ...)",
                 "void (anonymous namespace)::k5::wgrad_stem_kernel<false>(...)"):
        assert profile_step.bucket(name) == "K5 wgrad3x3 (port)", name
    assert (profile_step.bucket("void (anonymous namespace)::k6::dgrad_kernel<128, true, "
                                "true>(...)") == "K6 dgrad3x3 (port)")
    for name in ("void (anonymous namespace)::upsample2x_tile_kernel<8>(...)",
                 "void (anonymous namespace)::upsample2x_tile_kernel<1>(...)",
                 "void (anonymous namespace)::upsample2x_kernel(...)"):
        assert profile_step.bucket(name) == "K1f upsample (port)", name
    for name in ("void (anonymous namespace)::upsample2x_bwd_tile_kernel<8>(...)",
                 "_ZN12_GLOBAL__N_126upsample2x_bwd_tile_kernelILi1EEEvPK13__nv_bfloat16PS1_"
                 "PKfS6_xiiii",
                 "void (anonymous namespace)::upsample2x_bwd_kernel(...)"):
        assert profile_step.bucket(name) == "K1b upsample backward (port)", name
    for name in ("void (anonymous namespace)::k6::conv3x3_fwd_wgmma_kernel<128, true, "
                 "true>(...)",
                 "_ZN48_GLOBAL__N__31468701_15_conv3x3_bf16_cu_bc4e87552k624conv3x3_fwd_wgmma_"
                 "kernelILi64ELb0ELb1EEEv14CUtensorMap_stS2_PK13__nv_bfloat16NS0_3GeoE"):
        assert profile_step.bucket(name) == "K3/K4 conv3x3 (port)", name
    for name in ("void (anonymous namespace)::nhwc_kernel<0>(...)",
                 "void (anonymous namespace)::nhwc_kernel<1>(...)",
                 "void (anonymous namespace)::k6::pack_weights_k6(...)"):
        assert profile_step.bucket(name) == "bf16 packing (port)", name

