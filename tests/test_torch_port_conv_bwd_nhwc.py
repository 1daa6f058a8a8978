"""K5 and K6 in bf16 on ``wgmma`` over one NHWC cotangent: the cotangent
pass's plain version, the layout and the kernels' plans, on the CPU.

``csrc/conv3x3_bf16.cu`` runs only on the card. What decides and
addresses it is checked here:

- ``conv_bwd.cotangent_plain`` against the JAX package's g_tot expression
  (``pallas_conv.py:371-376``) on the same bf16 inputs: bit for bit, with
  the stats' terms and without (then g is gy itself);
- the NHWC layout (``to_nhwc`` / ``from_nhwc``): channels padded to a
  multiple of 8 with 0, and back;
- ``dgrad_plan`` and ``wgrad_plan`` at every K5/K6 launch of the batch-32
  320x320 ``pallas_fused`` step: shared memory within a block's 232,448
  bytes with at least two stages, TMA boxes of at most 256 per dimension
  and 16-byte rows and strides, tiles that cover the image, and a grid that
  fills the 132 SMs;
- :func:`emulate_k6` and :func:`emulate_k5`: the kernels' flattened-halo
  addressing in numpy (the haloed boxes as TMA lands them, each m64 row or
  k-step of 16 pixels read at the kernel's offsets, a k-step's second 8
  pixels starting the next row where the first 8 end one), in f64 against
  the plain versions to 1e-12, at the main-path plans' tile shapes on
  smaller images and at odd shapes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu_torch.ops import conv_bwd
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

SMEM_BLOCK, SMS = 232448, 132
# (B, Cin, H, W, Cout) of the K5/K6 launches of the batch-32 320x320 UNet
# step under pallas_fused (the stem, Cin = 1, has no K6 and its own K5)
MAIN = [(32, 1, 320, 320, 64), (32, 64, 320, 320, 64), (32, 64, 160, 160, 128),
        (32, 128, 160, 160, 128), (32, 128, 80, 80, 256), (32, 256, 80, 80, 256),
        (32, 256, 40, 40, 512), (32, 512, 40, 40, 512), (32, 512, 20, 20, 512),
        (32, 512, 40, 40, 256), (32, 256, 80, 80, 128), (32, 128, 160, 160, 64),
        (32, 64, 320, 320, 64)]


def _bf16(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 5, 7), (1, 3, 4, 9), (2, 64, 8, 8)])
def test_cotangent_plain_is_the_jax_expression(shape, stats):
    gy, y = _bf16(shape, 0), _bf16(shape, 1)
    b, c = shape[:2]
    gst = torch.from_numpy(np.random.RandomState(2).randn(b, 2, c).astype(np.float32)) * 0.1
    got = conv_bwd.cotangent_plain(gy, y if stats else None, gst if stats else None)
    # pallas_conv.py:371-376 on NHWC arrays
    gyj = jnp.asarray(gy.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
    if stats:
        yj = jnp.asarray(y.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
        gstj = jnp.asarray(gst.numpy())
        gs, gq = gstj[:, 0][:, None, None, :], gstj[:, 1][:, None, None, :]
        want = (gyj.astype(jnp.float32) + gs + 2.0 * yj.astype(jnp.float32) * gq).astype(gyj.dtype)
    else:
        want = gyj
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert got.shape == (b, shape[2], shape[3], conv_bwd.padded_channels(c))
    assert int((got[..., :c].float().numpy() != want).sum()) == 0
    assert not got[..., c:].any()


@pytest.mark.parametrize("c", [1, 3, 8, 13, 64])
def test_nhwc_layout_round_trip(c):
    t = _bf16((2, c, 3, 5), 4)
    p = conv_bwd.to_nhwc(t)
    assert p.shape == (2, 3, 5, conv_bwd.padded_channels(c)) and p.is_contiguous()
    assert conv_bwd.padded_channels(c) % 8 == 0 and conv_bwd.padded_channels(c) - c < 8
    assert torch.equal(p[..., :c], t.permute(0, 2, 3, 1))
    assert not p[..., c:].any()
    back = conv_bwd.from_nhwc(p, c)
    assert back.is_contiguous() and torch.equal(back, t)


@pytest.mark.parametrize("shape", sorted(set(s for s in MAIN if s[1] > 1)))
def test_dgrad_plan_at_the_main_path(shape):
    b, cin, h, w, cout = shape
    p = conv_bwd.dgrad_plan(b, cin, cout, h, w)
    mt = 64 * (4 if p.bn == 64 else 2) * 2
    hc = p.tw + 2
    assert p.bn in (64, 128) and p.ntn == -(-cin // p.bn)
    assert 2 <= p.stages <= 4 and p.smem <= SMEM_BLOCK
    assert (p.th - 1) * hc + p.tw <= mt  # the tile's positions fit the M rows
    assert hc <= 256 and p.th + 2 <= 256  # the g box
    assert p.plane >= max((p.th + 2) * hc, mt + 2 * hc + 2) * 16 and p.plane % 128 == 0
    assert -(-h // p.th) * -(-w // p.tw) * b == p.tiles
    assert conv_bwd.padded_channels(cout) * 2 % 16 == 0  # the NHWC map's pixel stride
    # the TMA epilogue at every level but 20x20 (whose rows are 40 bytes)
    assert (p.xs_bytes > 0) == (w % 8 == 0 and p.tw % 8 == 0) == (w != 20)
    if p.xs_bytes:
        assert p.tw * 2 % 16 == 0 and w * 2 % 16 == 0 and p.bn <= 256
        assert p.xs_bytes == -(-p.th * p.tw * p.bn * 2 // 128) * 128
    assert p.blocks == SMS and p.blocks % p.ntn == 0  # one block per SM
    # the last M row of each warpgroup's instances reads inside the plane
    assert (mt - 1 + 2 * hc + 2) * 16 <= p.plane


@pytest.mark.parametrize("shape", sorted(set(s for s in MAIN if s[1] > 1)))
def test_wgrad_plan_at_the_main_path(shape):
    b, cin, h, w, cout = shape
    p = conv_bwd.wgrad_plan(b, cin, cout, h, w)
    assert p.tw % 8 == 0 and p.th * p.tw % 16 == 0 and p.th * p.tw <= 256
    assert p.tw + 2 <= 256 and p.th + 2 <= 256
    assert 2 <= p.stages <= 4 and p.smem <= SMEM_BLOCK
    # boxes of 64 channels, 128 bytes a row, at 1024-byte (swizzle) bounds
    assert p.gbytes == -(-p.th * p.tw * 128 // 1024) * 1024
    assert p.abytes == -(-(p.th + 2) * (p.tw + 2) * 128 // 1024) * 1024
    assert p.smem == p.stages * (p.gbytes + p.abytes) + 16 * p.stages
    assert -(-h // p.th) * -(-w // p.tw) * b == p.tiles
    assert p.per_slice * (p.slices - 1) < p.tiles <= p.per_slice * p.slices
    assert p.per_slice * p.th * p.tw // 16 <= conv_bwd.K5_DEPTH
    assert p.blocks_per_slice == -(-cout // 64) * -(-conv_bwd.padded_channels(cin) // 64)
    waves = -(-p.blocks // SMS)
    assert p.blocks / (waves * SMS) >= 0.95  # the last wave fills the SMs


def test_stem_slices_cover_the_pixels():
    for npx in (1, 7, 528, 529, 32 * 320 * 320):
        per, slices = conv_bwd.stem_slices(npx)
        assert per * (slices - 1) < npx <= per * slices and slices <= 4 * SMS


def emulate_k6(g: np.ndarray, w: np.ndarray, plan) -> np.ndarray:
    """K6's da as the kernel addresses it: per tile the haloed box of g (0
    outside the image) flattened over HC = tw + 2 columns, M rows m read at
    m + dh·HC + dw for tap (dh, dw) against W[co, c, 8 - tap], and row m
    written to the pixel at box position m + HC + 1 where that is inside
    the tile and the image."""
    b, cout, h, wd = g.shape
    cin = w.shape[1]
    th, tw = plan.th, plan.tw
    hc = tw + 2
    mt = 64 * (4 if plan.bn == 64 else 2) * 2
    positions = max((th + 2) * hc, mt + 2 * hc + 2)
    wflip = np.stack([w[:, :, 2 - t // 3, 2 - t % 3] for t in range(9)])  # [tap][co][c]
    da = np.zeros((b, cin, h, wd))
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, tw):
                box = np.zeros((positions, cout))
                for i in range(th + 2):
                    for j in range(hc):
                        yy, xx = y0 - 1 + i, x0 - 1 + j
                        if 0 <= yy < h and 0 <= xx < wd:
                            box[i * hc + j] = g[bi, :, yy, xx]
                acc = sum(box[t // 3 * hc + t % 3:][:mt] @ wflip[t] for t in range(9))
                for m in range(mt):
                    rr, cc = divmod(m + hc + 1, hc)
                    rr, cc = rr - 1, cc - 1
                    if 0 <= cc < tw and rr < th and y0 + rr < h and x0 + cc < wd:
                        da[bi, :, y0 + rr, x0 + cc] = acc[m]
    return da


def emulate_k5(a: np.ndarray, g: np.ndarray, plan) -> tuple[np.ndarray, np.ndarray]:
    """K5's dW and db as the kernel addresses them: per tile g's box of th x
    tw pixels (0 outside the image) and the activation's haloed box over
    HC = tw + 2 columns; k-steps of 16 pixels, whose B halves are read at
    (r0 + dh)·HC + c0 + dw and at the next 8 pixels' own row and column."""
    b, cin, h, wd = a.shape
    cout = g.shape[1]
    th, tw = plan.th, plan.tw
    hc = tw + 2
    dw_ = np.zeros((cout, cin, 9))
    db = np.zeros((cout,))
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, tw):
                gbox = np.zeros((th * tw, cout))
                for p in range(th * tw):
                    yy, xx = y0 + p // tw, x0 + p % tw
                    if yy < h and xx < wd:
                        gbox[p] = g[bi, :, yy, xx]
                abox = np.zeros(((th + 2) * hc, cin))
                for i in range(th + 2):
                    for j in range(hc):
                        yy, xx = y0 - 1 + i, x0 - 1 + j
                        if 0 <= yy < h and 0 <= xx < wd:
                            abox[i * hc + j] = a[bi, :, yy, xx]
                db += gbox.sum(0)
                r0 = c0 = 0
                for k in range(th * tw // 16):
                    r1, c1 = (r0, c0 + 8) if c0 + 8 < tw else (r0 + 1, c0 + 8 - tw)
                    amat = gbox[16 * k:16 * k + 16]
                    for dh in range(3):
                        pos0, pos1 = (r0 + dh) * hc + c0, (r1 + dh) * hc + c1
                        for dwi in range(3):
                            bmat = np.concatenate([abox[pos0 + dwi:pos0 + dwi + 8],
                                                   abox[pos1 + dwi:pos1 + dwi + 8]])
                            dw_[:, :, 3 * dh + dwi] += amat.T @ bmat
                    c0 += 16
                    while c0 >= tw:
                        c0 -= tw
                        r0 += 1
    return dw_.reshape(cout, cin, 3, 3), db


def _f64(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


# (B, Cin, H, W, Cout, a main-path shape whose tile geometry is emulated,
# or None for the plan of the shape itself)
EMULATED = [(1, 8, 7, 320, 8, (32, 64, 320, 320, 64)),
            (1, 8, 5, 160, 8, (32, 128, 160, 160, 128)),
            (2, 8, 9, 40, 16, (32, 256, 40, 40, 512)),
            (2, 8, 20, 20, 8, (32, 512, 20, 20, 512)),
            (1, 3, 5, 7, 16, None), (2, 5, 13, 17, 24, None), (1, 16, 1, 1, 8, None)]


def _plan(fn, shape, main):
    b, cin, h, w, cout = shape
    own = fn(b, cin, cout, h, w)
    if main is None:
        return own
    mb, mcin, mh, mw, mcout = main
    ref = fn(mb, mcin, mcout, mh, mw)
    return dataclasses.replace(own, **{k: getattr(ref, k) for k in ("th", "tw")},
                               **({"bn": ref.bn} if hasattr(ref, "bn") else {}))


@pytest.mark.parametrize("case", EMULATED)
def test_k6_addressing_emulated(case):
    *shape, main = case
    b, cin, h, w, cout = shape
    plan = _plan(conv_bwd.dgrad_plan, shape, main)
    g, wt = _f64((b, cout, h, w), 1), _f64((cout, cin, 3, 3), 2)
    want = conv_bwd.dgrad3x3_plain(torch.from_numpy(g), torch.zeros(b, cin, h, w, dtype=torch.float64),
                                   torch.from_numpy(wt), None, None, False)[0].numpy()
    np.testing.assert_allclose(emulate_k6(g, wt, plan), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", EMULATED)
def test_k5_addressing_emulated(case):
    *shape, main = case
    b, cin, h, w, cout = shape
    plan = _plan(conv_bwd.wgrad_plan, shape, main)
    a, g = _f64((b, cin, h, w), 3), _f64((b, cout, h, w), 4)
    want_w, want_b = conv_bwd.wgrad3x3_plain(torch.from_numpy(a), torch.from_numpy(g), None, None,
                                             False)
    got_w, got_b = emulate_k5(a, g, plan)
    np.testing.assert_allclose(got_w, want_w.numpy(), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(got_b, want_b.numpy(), rtol=1e-12, atol=1e-10)


def test_nhwc_wrappers_take_the_plain_versions_on_the_cpu():
    x, g, wt = _bf16((2, 5, 6, 7), 5), _bf16((2, 16, 6, 7), 6), _bf16((16, 5, 3, 3), 7)
    sc = torch.rand(5) + 0.5
    sh = torch.rand(5)
    before = (conv_bwd.cotangent_nhwc.launches, conv_bwd.wgrad3x3.bf16.launches,
              conv_bwd.dgrad3x3.bf16.launches)
    gp = conv_bwd.cotangent_nhwc(g, None, None)
    assert torch.equal(gp, conv_bwd.to_nhwc(g))
    for got, want in zip(conv_bwd.wgrad3x3_nhwc(x, gp, 16, sc, sh, True),
                         conv_bwd.wgrad3x3_plain(x, g, sc, sh, True)):
        assert torch.equal(got, want)
    for got, want in zip(conv_bwd.dgrad3x3_nhwc(gp, x, wt, sc, sh, True),
                         conv_bwd.dgrad3x3_plain(g, x, wt, sc, sh, True)):
        assert torch.equal(got, want)
    assert (conv_bwd.cotangent_nhwc.launches, conv_bwd.wgrad3x3.bf16.launches,
            conv_bwd.dgrad3x3.bf16.launches) == before
    meta = torch.empty((1, 2, 3, 4), device="meta")
    for call in (lambda: conv_bwd.cotangent_nhwc(meta, None, None),
                 lambda: conv_bwd.wgrad3x3_nhwc(meta, meta, 2, None, None, False),
                 lambda: conv_bwd.dgrad3x3_nhwc(meta, meta, meta, None, None, False)):
        with pytest.raises(RuntimeError, match="cuda or cpu"):
            call()
