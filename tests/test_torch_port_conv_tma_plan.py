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
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from im2im_uq_tpu_torch.ops import conv_probe
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

SMEM_BLOCK = 232448


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
    assert not conv_probe.uses_tma(x.float(), k.float())
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
