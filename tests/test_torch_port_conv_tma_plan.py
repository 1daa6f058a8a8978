"""P2-P5's bf16 path on ``wgmma`` with TMA: its host-side plan and its
data layout, on the CPU.

``csrc/conv3x3_nhwc.cu`` (namespace ``tma``) runs only on the card. What
decides and addresses it is checked here:

- ``conv_probe.tma_plan``: which (Cin, Cout) take the TMA path (Cin and
  Cout multiples of 8, the weights of one slice resident), and that every
  plan fits a block's shared memory with at least two stages and at most
  128 accumulators a thread;
- ``conv_probe.uses_tma``: bf16 only, 16-byte aligned tensors only;
- :func:`emulate`: the kernel's layouts in numpy. The packed weights as
  ``pack_weights_kernel`` indexes them, the haloed boxes as TMA lands them
  ([group][row][col][8], zero outside the image and past Cin), and every
  product read through the kernel's descriptors (K-major, no swizzle: A
  with SBO = 128 bytes and LBO = the group's plane, B with LBO = 128 and
  SBO = 256), summed in f32 and rounded once to bf16. It is held to
  ``conv3x3_nobias_plain`` within ``bf16_tolerance`` on ragged shapes.

And the same of the float32 path (3xTF32 on ``wgmma``):

- ``conv_probe.tma_plan(..., torch.float32)``: Cin and Cout multiples of 4
  (TMA's 16-byte strides), every plan within a block's shared memory with
  its ring of four stages (each a chunk's box and its streamed weights) and
  at most 128 sums and partials a thread, and its choice of bn;
- ``conv_probe.uses_tma`` on float32 tensors: aligned ones with a plan;
- :func:`emulate_f32`: the weights packed as ``pack_weights_f32_kernel``
  indexes and splits them (tf32 hi and lo, K-major, each tap's rows
  permuted to channels 0, 2, 4, 6, 1, 3, 5, 7), a chunk's 8-channel box as
  TMA lands it ([row][col][8], zero outside the image and past Cin), each
  lane's A read at the tap's offset and split, B read through the
  descriptors (LBO = 128, SBO = 256 bytes), the three TF32 products (tf32
  as the low 13 bits cleared: after rounding for hi, as ``tc::split`` does,
  by truncation for lo, as the tensor core reads it) summed into a partial
  per chunk that is added to the sums in f32. It is held to
  ``conv3x3_nobias_plain`` within the probe's bar, 2e-5, on ragged shapes
  and at every instance the plan may pick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from im2im_uq_tpu_torch.ops import conv_probe
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

SMEM_BLOCK = 232448
F32 = torch.float32
CONV_PROBE_TOL = 2e-5  # the probe's bar (benchmarks/bench_pallas_conv.py:399)


def test_plan_takes_whole_16_byte_strides_only():
    for cin, cout in [(3, 7), (5, 8), (8, 7), (12, 16), (96, 4), (1, 64)]:
        assert conv_probe.tma_plan(cin, cout) is None
    for cin, cout in [(8, 8), (24, 24), (200, 200), (64, 40)]:
        assert conv_probe.tma_plan(cin, cout) is not None


def test_plan_at_the_cli_shapes():
    p5, p4, p2 = (conv_probe.tma_plan(c, c) for c in (64, 96, 128))
    assert (p5.bn, p5.ntn, p5.rows, p5.groups, p5.stages) == (64, 1, 8, 4, 3)
    assert (p4.bn, p4.ntn, p4.rows, p4.groups, p4.stages) == (96, 1, 4, 2, 4)
    assert (p2.bn, p2.ntn, p2.rows, p2.groups, p2.stages) == (64, 2, 8, 2, 3)


def test_plan_refuses_weights_that_do_not_fit():
    # 9 x 1024 x 16 x 2 bytes of one 16-channel slice are more than a block holds
    assert conv_probe.tma_plan(1024, 64) is None


@pytest.mark.parametrize("cin", [8, 16, 24, 40, 64, 96, 128, 200, 256, 512])
@pytest.mark.parametrize("cout", [8, 24, 40, 64, 96, 128, 200, 256])
def test_every_plan_fits_a_block(cin, cout):
    plan = conv_probe.tma_plan(cin, cout)
    assert plan is not None
    kc = 8 * plan.groups
    plane = -(-(plan.rows + 2) * 66 * 16 // 128) * 128
    wbytes = 9 * (-(-cin // kc) * kc) * plan.bn * 2
    assert plan.smem == wbytes + plan.stages * plan.groups * plane + (2 * plan.stages + 1) * 8
    assert plan.smem <= SMEM_BLOCK
    assert plan.stages >= 2 and plan.groups % 2 == 0 and kc <= -(-cin // 16) * 16
    assert plan.ntn * plan.bn >= cout > (plan.ntn - 1) * plan.bn
    assert plan.rows // 2 * plan.bn // 2 <= 128  # accumulators a consumer thread


def test_uses_tma_only_for_aligned_bf16():
    x = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 64, 64), dtype=torch.bfloat16)
    assert conv_probe.uses_tma(x, k)
    # float32 has a TMA path of its own (test_uses_tma_for_aligned_f32); mixed
    # dtypes and other dtypes take none
    assert not conv_probe.uses_tma(x, k.float())
    assert not conv_probe.uses_tma(x.double(), k.double())
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert shifted.is_contiguous() and not conv_probe.uses_tma(shifted, k)
    assert not conv_probe.uses_tma(x[..., :60].contiguous(), k[:, :, :60].contiguous())


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def emulate(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The TMA path's conv by its own layouts and descriptors, in numpy."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    plan = conv_probe.tma_plan(cin, cout)
    bn, th, groups = plan.bn, plan.rows, plan.groups
    kc, steps, hc = 8 * groups, groups // 2, 66
    nch = -(-cin // kc)
    plane = -(-(th + 2) * hc * 16 // 128) * 128
    wchunk = 9 * kc * bn * 2
    # pack_weights_kernel: wpack[ns][c][tap][ks][ng][kh][8 n][8 k], in bf16 elements
    total = plan.ntn * nch * wchunk // 2
    e = np.arange(total)
    k8, e = e % 8, e // 8
    n8, e = e % 8, e // 8
    kh, e = e % 2, e // 2
    ng, e = e % (bn // 8), e // (bn // 8)
    ks, e = e % steps, e // steps
    tap, e = e % 9, e // 9
    c, ns = e % nch, e // nch
    k = c * kc + ks * 16 + kh * 8 + k8
    n = ns * bn + ng * 8 + n8
    ok = (k < cin) & (n < cout)
    wflat = w.reshape(9, cin, cout)
    wpack = np.where(ok, wflat[tap, np.minimum(k, cin - 1), np.minimum(n, cout - 1)], 0.0)
    wpack = wpack.astype(np.float32)

    xpad = np.zeros((b, h + th + 2, wd + 66, cin + kc), np.float32)
    xpad[:, 1:h + 1, 1:wd + 1, :cin] = x
    y = np.zeros((b, h, wd, cout), np.float32)
    m = np.arange(64)
    kk = np.arange(16)
    nn = np.arange(bn)
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, 64):
                for sl in range(plan.ntn):
                    acc = np.zeros((th, 64, bn), np.float32)
                    for ch in range(nch):
                        # the stage: one TMA box per group, plane bytes apart, 2-byte units
                        stage = np.zeros(groups * plane // 2, np.float32)
                        for gi in range(groups):
                            c0 = (ch * groups + gi) * 8
                            box = xpad[bi, y0:y0 + th + 2, x0:x0 + hc, c0:c0 + 8]
                            stage[gi * plane // 2: gi * plane // 2 + box.size] = box.reshape(-1)
                        base_w = (sl * nch + ch) * wchunk // 2
                        for t in range(9):
                            dh, dw = divmod(t, 3)
                            for s in range(steps):
                                bstart = base_w + (t * steps + s) * (bn // 8) * 256 // 2
                                # B (16 k x bn n): LBO 128 (k groups), SBO 256 (n groups)
                                baddr = (bstart + (nn[None, :] // 8) * 128 + (nn[None, :] % 8) * 8
                                         + (kk[:, None] // 8) * 64 + kk[:, None] % 8)
                                bmat = wpack[baddr]
                                for row in range(th):
                                    astart = (s * 2 * plane + ((row + dh) * hc + dw) * 16) // 2
                                    # A (64 m x 16 k): SBO 128 (m groups), LBO plane (k groups)
                                    aaddr = (astart + (m[:, None] // 8) * 64 + (m[:, None] % 8) * 8
                                             + (kk[None, :] // 8) * plane // 2 + kk[None, :] % 8)
                                    acc[row] += stage[aaddr] @ bmat
                    rows = min(th, h - y0)
                    cols = min(64, wd - x0)
                    n0, n1 = sl * bn, min(cout, (sl + 1) * bn)
                    y[bi, y0:y0 + rows, x0:x0 + cols, n0:n1] = acc[:rows, :cols, :n1 - n0]
    return _bf16(y)


@pytest.mark.parametrize("shape", [(1, 5, 70, 24, 40), (2, 9, 13, 8, 8), (1, 3, 66, 48, 96),
                                   (1, 2, 5, 200, 24)])
def test_emulated_tma_layout_matches_the_plain_version(shape):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    x = _bf16(rng.randn(b, h, w, cin).astype(np.float32))
    k = _bf16((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    want = conv_probe.conv3x3_nobias_plain(xt, kt)
    tol = conv_probe.bf16_tolerance(xt, kt, want).numpy()
    got = emulate(x, k)
    assert (np.abs(got - want.float().numpy()) <= tol).all()


# ---------------------------------------------------------------- float32


def test_f32_plan_takes_whole_16_byte_strides_only():
    for cin, cout in [(3, 8), (5, 8), (8, 7), (4, 6), (1, 64), (64, 2), (0, 8)]:
        assert conv_probe.tma_plan(cin, cout, F32) is None
    for cin, cout in [(4, 4), (12, 4), (4, 12), (8, 8), (64, 64), (200, 200), (1024, 64)]:
        assert conv_probe.tma_plan(cin, cout, F32) is not None
    assert conv_probe.tma_plan(64, 64, torch.float16) is None


def test_f32_plan_widths():
    # PROBE_SHAPE's channels: one slice of 64, whose hi and lo weights
    # (294,912 bytes) stream through the ring
    probe = conv_probe.tma_plan(64, 64, F32)
    assert (probe.bn, probe.ntn, probe.rows, probe.groups, probe.stages) == (64, 1, 4, 1, 4)
    # the width that pads N least, 64 on a tie
    for cin, cout, bn, ntn in [(64, 40, 64, 1), (1024, 64, 64, 1), (64, 128, 64, 2),
                               (4, 12, 32, 1), (12, 4, 32, 1), (24, 24, 32, 1),
                               (96, 96, 32, 3), (200, 200, 32, 7), (8, 192, 64, 3)]:
        plan = conv_probe.tma_plan(cin, cout, F32)
        assert (plan.bn, plan.ntn) == (bn, ntn), (cin, cout, plan)


@pytest.mark.parametrize("cin", [4, 8, 12, 24, 64, 96, 128, 200, 512, 1024])
@pytest.mark.parametrize("cout", [4, 8, 40, 64, 96, 128, 200])
def test_every_f32_plan_fits_a_block(cin, cout):
    plan = conv_probe.tma_plan(cin, cout, F32)
    box = (plan.rows + 2) * 66 * 32  # a chunk's 8 channels, 32 bytes a pixel
    wchunk = 9 * 8 * plan.bn * 8  # its weights' hi and lo, 4 bytes each
    assert plan.smem == plan.stages * (box + wchunk) + 2 * plan.stages * 8
    assert plan.smem <= SMEM_BLOCK and plan.stages == 4 and plan.groups == 1
    assert plan.ntn * plan.bn >= cout > (plan.ntn - 1) * plan.bn
    assert plan.rows // 2 * plan.bn <= 128  # the sums and the partial, a consumer thread


def test_uses_tma_for_aligned_f32():
    b, cin, h, w, cout = 32, 64, 320, 320, 64  # chip_smoke.PROBE_SHAPE
    x = torch.zeros((1, 1, 1, cin)).expand(b, h, w, cin)  # the shape without its memory
    k = torch.zeros((3, 3, cin, cout))
    assert conv_probe.uses_tma(x, k)
    shifted = torch.zeros(4 * 64 + 1)[1:].view(1, 2, 2, 64)
    assert not conv_probe.uses_tma(shifted, k)
    assert not conv_probe.uses_tma(torch.zeros((1, 2, 2, 6)), torch.zeros((3, 3, 6, 8)))
    assert not conv_probe.uses_tma(torch.zeros((1, 2, 2, 8)), torch.zeros((3, 3, 8, 6)))


def test_cp_async_runs_cuda_tensors_only():
    """The comparison path launches its kernel or raises: no plain version."""
    x, k = torch.zeros((1, 2, 2, 64)), torch.zeros((3, 3, 64, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_probe.cp_async(conv_probe.conv3x3_c64, x, k)
    with pytest.raises(ValueError, match="3x3 HWIO"):
        conv_probe.cp_async(conv_probe.conv3x3_l1, x, torch.zeros((3, 3, 8, 8)))


def _tf32_round(a: np.ndarray) -> np.ndarray:
    """hi as ``tc::split`` makes it: 0x1000 added to the bits, the low 13
    cleared (to nearest, ties away from zero)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a: np.ndarray) -> np.ndarray:
    """A .tf32 operand as the tensor core reads it: its top 19 bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a: np.ndarray) -> tuple:
    hi = _tf32_round(a)
    return hi, (a.astype(np.float32) - hi).astype(np.float32)


# A's column j of a chunk's tap: channel 2 j (j < 4) or 2 (j - 4) + 1
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def pack_f32(w: np.ndarray, plan) -> np.ndarray:
    """``pack_weights_f32_kernel``: wpack[slice][chunk][tap][hi, lo][n
    group][k half][8 n][4 k], row (kh, k4) of a chunk's tile its channel
    2 k4 + kh."""
    cin, cout = w.shape[2], w.shape[3]
    bn, nch = plan.bn, -(-cin // 8)
    e = np.arange(plan.ntn * nch * 9 * 2 * bn * 8)
    k4, e = e % 4, e // 4
    n8, e = e % 8, e // 8
    kh, e = e % 2, e // 2
    ng, e = e % (bn // 8), e // (bn // 8)
    part, e = e % 2, e // 2
    tap, e = e % 9, e // 9
    c, ns = e % nch, e // nch
    k = c * 8 + 2 * k4 + kh
    n = ns * bn + ng * 8 + n8
    ok = (k < cin) & (n < cout)
    wflat = w.reshape(9, cin, cout)
    v = np.where(ok, wflat[tap, np.minimum(k, cin - 1), np.minimum(n, cout - 1)], 0.0)
    hi, lo = _split(v.astype(np.float32))
    return np.where(part == 0, hi, lo).astype(np.float32)


def emulate_f32(x: np.ndarray, w: np.ndarray, plan) -> np.ndarray:
    """The float32 TMA path's conv by its own layouts and descriptors."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    bn, th, nch = plan.bn, plan.rows, -(-cin // 8)
    wpack = pack_f32(w, plan)
    xpad = np.zeros((b, h + th + 2, wd + 66, nch * 8), np.float32)
    xpad[:, 1:h + 1, 1:wd + 1, :cin] = x
    kk = np.arange(8)[:, None]
    nn = np.arange(bn)[None, :]
    # B (8 k x bn n) of a tap at its tile's start: LBO 128 bytes (k halves),
    # SBO 256 (n groups), 16-byte core-matrix rows of 4 k
    boff = (nn // 8) * 64 + (kk // 4) * 32 + (nn % 8) * 4 + kk % 4
    rr = np.arange(th)[:, None]
    mm = np.arange(64)[None, :]
    y = np.zeros((b, h, wd, cout), np.float32)
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, 64):
                for ns in range(plan.ntn):
                    acc = np.zeros((th, 64, bn), np.float32)
                    for c in range(nch):
                        box = xpad[bi, y0:y0 + th + 2, x0:x0 + 66, 8 * c:8 * c + 8]  # as TMA lands it
                        part = np.zeros((th, 64, bn), np.float32)
                        for tap in range(9):
                            dh, dw = divmod(tap, 3)
                            ah, al = _split(box[rr + dh, mm + dw][..., PERM])  # (rows, 64, 8)
                            al = _tf32_trunc(al)
                            base = ((ns * nch + c) * 9 + tap) * 2 * 8 * bn
                            bh = wpack[base + boff]
                            bl = _tf32_trunc(wpack[base + 8 * bn + boff])
                            part = (part + al @ bh).astype(np.float32)
                            part = (part + ah @ bl).astype(np.float32)
                            part = (part + ah @ bh).astype(np.float32)
                        acc = (acc + part).astype(np.float32)
                    rows, cols = min(th, h - y0), min(64, wd - x0)
                    n0, n1 = ns * bn, min(cout, (ns + 1) * bn)
                    y[bi, y0:y0 + rows, x0:x0 + cols, n0:n1] = acc[:rows, :cols, :n1 - n0]
    return y


def _f32_case(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    want = conv_probe.conv3x3_nobias_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    return x, k, want


@pytest.mark.parametrize("shape", [(1, 9, 70, 24, 40), (2, 5, 13, 12, 8), (1, 2, 5, 4, 12),
                                   (1, 3, 66, 64, 64)])
def test_emulated_f32_tma_layout_matches_the_plain_version(shape):
    x, k, want = _f32_case(shape, sum(shape))
    got = emulate_f32(x, k, conv_probe.tma_plan(shape[3], shape[4], F32))
    np.testing.assert_allclose(got, want, rtol=CONV_PROBE_TOL, atol=CONV_PROBE_TOL)


@pytest.mark.parametrize("bn", [64, 32])
def test_emulated_f32_widths_match_the_plain_version(bn):
    shape = (1, 9, 67, 20, 36)  # past a tile in H and W, a channel tail, N padded
    x, k, want = _f32_case(shape, 7)
    plan = dataclasses.replace(conv_probe.tma_plan(20, 36, F32), bn=bn, ntn=-(-36 // bn))
    np.testing.assert_allclose(emulate_f32(x, k, plan), want, rtol=CONV_PROBE_TOL,
                               atol=CONV_PROBE_TOL)


def test_emulated_f32_split_is_needed():
    """One TF32 pass (hi·hi alone) misses the bar: the split is what makes
    the path float32-accurate."""
    x, k, want = _f32_case((1, 3, 66, 64, 64), 11)
    one = conv_probe.conv3x3_nobias_plain(torch.from_numpy(_tf32_round(x)),
                                          torch.from_numpy(_tf32_round(k))).numpy()
    assert np.abs(one - want).max() > 10 * CONV_PROBE_TOL
