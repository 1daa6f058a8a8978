"""K5's float32 path on ``wgmma`` in 3xTF32 fed by TMA: its host-side plan
and its data layout, on the CPU.

``csrc/wgrad3x3_tma.cu`` runs only on the card. What decides and
addresses it is checked here:

- ``conv_bwd.wgrad_f32_plan``: which shapes take the TMA path (Cin a
  multiple of 16, W of 4; never the stem), and that every plan fits a
  block's shared memory with a ring of at least five stages, covers every
  chunk with its slices, and picks the chunk widths the step's levels need;
- ``conv_bwd.wgrad_f32_uses_tma``: float32 only, 16-byte aligned tensors
  only; ``wgrad3x3_mma_sync`` runs CUDA tensors only;
- :func:`emulate`: the kernel in numpy, one block at a time over a flat
  image of its shared memory (NaN where nothing landed): the events of a
  slice (two warm-ups at each strip's first chunk), g's boxes as TMA lands
  them ([co][4 pixels], zero outside the tensor) split into tf32 hi (in
  place) and lo, the activation rows ([16 channels][HC] from the strip's
  x0 - 4, zero outside the image)
  each consumer warp's A read at its (channel group, tap) offset in the
  stage of event e - 2 + dh, the prologue applied to its in-image elements
  and split, B read through the descriptors (K-major, no
  swizzle: LBO = 1 KB between 4-pixel boxes, SBO = 128 bytes between
  8-channel groups), the three TF32 products (tf32 as the low 13 bits
  cleared: after rounding for hi, as ``tc::split`` does, by truncation for
  lo, as the tensor core reads it) into each consumer warpgroup's partial,
  added to its sums in f32 every stages - 4 chunks (the two warpgroups half
  a period apart) and before a strip's warm-ups, db as four running sums
  a thread, the partials of dW and db per slice, and their sum over the
  slices in order. It is held to ``wgrad3x3_plain`` within the k5 bars
  (1e-4) on ragged shapes with and without the prologue; one TF32 pass
  misses them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from im2im_uq_tpu_torch.ops import conv_bwd
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

SMEM_BLOCK = 232448
SUM_TOL = 1e-4  # K5's bars against its plain version (chip_smoke.SUM_TOL)
# the wrapper's shapes at batch 32, 320x320: every K5 launch of the f32
# pallas_fused UNet step but the stem, and WNet's
STEP_SHAPES = [(32, 64, 320, 320, 64), (32, 64, 160, 160, 128), (32, 128, 160, 160, 128),
               (32, 128, 80, 80, 256), (32, 256, 80, 80, 256), (32, 256, 40, 40, 512),
               (32, 512, 40, 40, 512), (32, 512, 20, 20, 512), (32, 512, 40, 40, 256),
               (32, 256, 80, 80, 128), (32, 128, 160, 160, 64), (32, 32, 320, 320, 32),
               (32, 32, 160, 160, 64), (32, 64, 80, 80, 128), (32, 128, 40, 40, 256),
               (32, 256, 20, 20, 256), (32, 64, 160, 160, 64), (32, 128, 80, 80, 128),
               (32, 256, 40, 40, 256)]


def test_plan_takes_16_channel_groups_and_16_byte_rows_only():
    # the stem, Cin off the 16-channel groups, W off TMA's 16-byte rows
    for b, cin, h, w, cout in [(2, 1, 1, 1, 8), (1, 1, 13, 17, 64), (1, 3, 5, 7, 16),
                               (2, 64, 13, 17, 24), (1, 64, 5, 7, 64), (1, 24, 8, 8, 8),
                               (1, 16, 8, 6, 8), (1, 0, 8, 8, 8), (1, 16, 8, 8, 0)]:
        assert conv_bwd.wgrad_f32_plan(b, cin, cout, h, w) is None, (b, cin, h, w, cout)
    for b, cin, h, w, cout in [(1, 16, 1, 4, 1), (1, 128, 160, 160, 128), (2, 32, 13, 20, 24),
                               (3, 48, 7, 44, 72)] + STEP_SHAPES:
        assert conv_bwd.wgrad_f32_plan(b, cin, cout, h, w) is not None, (b, cin, h, w, cout)


@pytest.mark.parametrize("shape", STEP_SHAPES + [(1, 128, 160, 160, 128), (2, 32, 13, 20, 24),
                                                 (1, 16, 1, 4, 1), (3, 48, 7, 44, 72),
                                                 (1, 1024, 9, 500, 1000), (64, 16, 2, 12, 8)])
def test_every_plan_fits_a_block_and_covers_the_chunks(shape):
    b, cin, h, w, cout = shape
    p = conv_bwd.wgrad_f32_plan(b, cin, cout, h, w)
    # g's hi and lo (64 channels x tw pixels x 4 bytes each), a row of 48
    # channels x (tw + 12) of the activation, 1 KB aligned
    stage = -(-(2 * 64 * p.tw * 4 + 48 * (p.tw + 12) * 4) // 1024) * 1024
    assert (p.stage_bytes, p.hc) == (stage, p.tw + 12)
    assert p.smem == p.stages * (stage + 3 * 8) <= SMEM_BLOCK  # and three mbarriers a stage
    assert 5 <= p.stages <= 8 and p.tw % 8 == 0 and p.hc % 8 == 4  # HC = 4 mod 8: no bank conflicts
    assert p.chunks == b * -(-w // p.tw) * h
    assert p.per_slice * (p.slices - 1) < p.chunks <= p.per_slice * p.slices
    assert p.mtiles == -(-9 * (cin // 16) // 16) and p.ntiles == -(-cout // 64)
    assert p.blocks < 2 ** 31


def test_plan_widths_at_the_step_levels():
    # W 320 to 40: strips of 40 (7 stages); 20: 24 (8)
    for w, tw, stages in [(320, 40, 7), (160, 40, 7), (80, 40, 7), (40, 40, 7), (20, 24, 8)]:
        p = conv_bwd.wgrad_f32_plan(32, 512, 512, w, w)
        assert (p.tw, p.stages) == (tw, stages), (w, p)
    # the levels' blocks fill whole waves of the 132 SMs or come close
    for b, cin, h, w, cout in STEP_SHAPES[:11]:
        p = conv_bwd.wgrad_f32_plan(b, cin, cout, h, w)
        assert p.blocks / (-(-p.blocks // 132) * 132) >= 0.7, (b, cin, h, w, cout, p)


def test_the_fused_step_runs_13_of_its_14_k5_launches_on_the_tma_path():
    """``chip_smoke.require_tma_per_step``'s K5 count: one K5 a K4 of the f32
    pallas_fused step at batch 32, 320x320, every one but the stem's on
    the plan."""
    import chip_smoke

    sites = chip_smoke.conv_sites("pallas_fused")["wgrad3x3"]
    planned = [(b, ci, h, w, co) for (b, ci, h, w, co), _ in sites
               if conv_bwd.wgrad_f32_plan(b, ci, co, h, w) is not None]
    assert (len(sites), len(planned)) == (14, 13)
    assert {s[1] for (s, _) in sites} - {s[1] for s in planned} == {1}


def test_uses_tma_for_aligned_f32_only():
    x = torch.zeros((1, 1, 1, 1)).expand(32, 64, 320, 320)  # the shape without its memory
    g = torch.zeros((1, 1, 1, 1)).expand(32, 64, 320, 320)
    assert conv_bwd.wgrad_f32_uses_tma(x, g)
    assert not conv_bwd.wgrad_f32_uses_tma(x.to(torch.bfloat16), g.to(torch.bfloat16))
    shifted = torch.zeros(16 * 4 * 4 + 1)[1:].view(1, 16, 4, 4)
    assert not conv_bwd.wgrad_f32_uses_tma(shifted, torch.zeros((1, 8, 4, 4)))
    assert conv_bwd.wgrad_f32_uses_tma(torch.zeros((1, 16, 4, 4)), torch.zeros((1, 8, 4, 4)))
    assert not conv_bwd.wgrad_f32_uses_tma(torch.zeros((1, 8, 4, 4)), torch.zeros((1, 8, 4, 4)))
    assert not conv_bwd.wgrad_f32_uses_tma(torch.zeros((1, 16, 4, 6)), torch.zeros((1, 8, 4, 6)))


def test_mma_sync_runs_cuda_tensors_only():
    """The comparison path launches its kernel or raises: no plain version."""
    x, g = torch.zeros((1, 16, 4, 4)), torch.zeros((1, 8, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_bwd.wgrad3x3_mma_sync(x, g, None, None, False)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 16, 5, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 8, 5, 8).astype(np.float32))
    before = (conv_bwd.wgrad3x3.launches, conv_bwd.wgrad3x3.tma.launches)
    got = conv_bwd.wgrad3x3(x, g, None, None, False)
    want = conv_bwd.wgrad3x3_plain(x, g, None, None, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (conv_bwd.wgrad3x3.launches, conv_bwd.wgrad3x3.tma.launches) == before


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::k5f::wgrad3x3_tma_kernel<true>(CUtensorMap_st, CUtensorMap_st, "
    "(anonymous namespace)::k5f::Geo)",
    "_ZN48_GLOBAL__N__5af31644_15_wgrad3x3_tma_cu_3892287c3k5f19wgrad3x3_tma_kernelILb0EEEv14"
    "CUtensorMap_stS1_NS0_3GeoE"])
def test_profile_bucket_of_the_tma_kernel(name):
    from im2im_uq_tpu_torch.utils import profiling

    assert profiling.bucket(name) == "K5 wgrad3x3 (port)"


# ---------------------------------------------------------------- emulation


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
    return hi, (np.asarray(a, np.float32) - hi).astype(np.float32)


def _affine_relu(v, sc, sh):
    return np.maximum((v * sc).astype(np.float32) + sh, 0.0).astype(np.float32)


def _events(k0: int, k1: int, nxs: int, h: int, tw: int):
    """(b, x0, y, v) of a slice's events, v: 0 and 1 the warm-ups (the
    activation rows y - 1 and y), 2 the chunk (g's row y, the activation
    row y + 1)."""
    for k in range(k0, k1):
        b, r = divmod(k, nxs * h)
        xs, y = divmod(r, h)
        for v in range(0 if k == k0 or y == 0 else 2, 3):
            yield b, xs * tw, y, v


def emulate(x: np.ndarray, g: np.ndarray, scale, shift, prologue: bool,
            plan: conv_bwd.WgradF32Plan, mode: str = "3xtf32") -> tuple:
    """``wgrad3x3_tma_kernel`` and the sums over its slices, by its own
    layouts (see the module docstring) → (dW, db). mode "tf32": one pass,
    hi·hi alone."""
    b, cin, h, w = x.shape
    cout = g.shape[1]
    tw, hc, s_n = plan.tw, plan.hc, plan.stages
    gf = tw // 4 * 256  # floats of g's hi (or lo) in a stage
    sf = plan.stage_bytes // 4
    rf = 16 * hc  # floats of one 16-channel activation row
    nxs, ncg = -(-w // tw), cin // 16
    xpad = np.zeros((b, ncg * 16 + 48, h + 2, -(-w // tw) * tw + hc), np.float32)
    xpad[:, :cin, 1:h + 1, 4:w + 4] = x  # a box from column x0 - 4 at x0
    gpad = np.zeros((b, -(-cout // 64) * 64, h, nxs * tw + 4), np.float32)
    gpad[:, :cout, :, :w] = g
    part = np.zeros((plan.slices, cout, cin, 9), np.float32)
    part_b = np.zeros((plan.slices, cout), np.float32)
    k_ = np.arange(8)
    n_ = np.arange(64)
    # B (8 k x 64 n) of a k-step from its descriptor: LBO 1 KB (k boxes of
    # 4), SBO 128 bytes (n groups of 8), 16-byte core-matrix rows of 4 k
    boff = (k_[:, None] // 4) * 256 + (n_[None, :] // 8) * 32 + (n_[None, :] % 8) * 4 + k_[:, None] % 4
    r_ = np.arange(16)
    for slice_ in range(plan.slices):
        k0 = slice_ * plan.per_slice
        k1 = min(k0 + plan.per_slice, plan.chunks)
        for mt in range(plan.mtiles):
            cg0 = 16 * mt // 9
            nslots = min((16 * mt + 15) // 9, ncg - 1) - cg0 + 1
            # the 16 warps' row groups (2 warpgroups x 2 instances x 4 warps)
            q = 16 * mt + np.arange(16)
            ok = q < 9 * ncg
            cg = np.where(ok, q // 9, cg0)
            tap = np.where(ok, q % 9, 0)
            for nt in range(plan.ntiles):
                co0 = 64 * nt
                smem = np.full(s_n * sf, np.nan, np.float32)
                acc = np.zeros((256, 64), np.float32)
                pt = np.zeros((256, 64), np.float32)
                period = s_n - 4  # chunks between drains, the warpgroups half a period apart
                left0 = [period, period - period // 2]
                left = list(left0)
                db4 = np.zeros((64, 4), np.float32)
                events = list(_events(k0, k1, nxs, h, tw))
                for e, (bi, x0, y, v) in enumerate(events):
                    st = (e % s_n) * sf
                    # TMA: g's boxes [co][4] (a chunk), then the activation row
                    if v == 2:
                        box = gpad[bi, co0:co0 + 64, y, x0:x0 + tw].reshape(64, tw // 4, 4)
                        smem[st:st + gf] = box.transpose(1, 0, 2).ravel()
                    row = y - 1 + v  # the activation row, padded row + 1
                    for j in range(nslots):
                        a = xpad[bi, (cg0 + j) * 16:(cg0 + j + 1) * 16, row + 1, x0:x0 + hc]
                        smem[st + 2 * gf + j * rf:st + 2 * gf + (j + 1) * rf] = a.ravel()
                    # the split warps: hi in place, lo beside it; db as four
                    # running sums a thread (co), one per pixel of a box
                    if v == 2:
                        raw = smem[st:st + gf].copy()
                        for blk in raw.reshape(tw // 4, 64, 4):
                            db4 = (db4 + blk).astype(np.float32)
                        hi, lo = _split(raw)
                        smem[st:st + gf] = hi
                        smem[st + gf:st + 2 * gf] = lo
                    if v != 2:
                        continue
                    # the consumers' prologue: the group's channels, its row
                    # y - 1 + dh in the image, and each pixel's column
                    chan = (cg * 16)[:, None] + r_[None, :]
                    row_in = (0 <= y - 1 + tap // 3) & (y - 1 + tap // 3 < h)
                    for ks in range(tw // 8):
                        # A (256 rows x 8 k): warp group q's 16 rows, channel r, at
                        # the stage of event e - 2 + dh, column tap % 3 + 3 + pixel
                        stq = ((e - 2 + tap // 3) % s_n) * sf + 2 * gf + (cg - cg0) * rf + tap % 3 + 3
                        aidx = stq[:, None, None] + r_[None, :, None] * hc + 8 * ks + k_[None, None, :]
                        a = smem[aidx]  # (16 groups, 16 channels, 8 pixels)
                        if prologue:
                            xi = x0 + 8 * ks + k_[None, :] + (tap % 3)[:, None] - 1
                            inside = row_in[:, None] & (xi >= 0) & (xi < w)  # (group, pixel)
                            act = _affine_relu(a, scale[chan][..., None], shift[chan][..., None])
                            a = np.where(inside[:, None, :], act, a)
                        ah, al = _split(a.reshape(256, 8))
                        bh = smem[st + 2 * 1024 // 4 * ks + boff]
                        bl = _tf32_trunc(smem[st + gf + 2 * 1024 // 4 * ks + boff])
                        al = _tf32_trunc(al)
                        if mode == "tf32":
                            pt = (pt + ah @ bh).astype(np.float32)
                            continue
                        pt = (pt + al @ bh).astype(np.float32)
                        pt = (pt + ah @ bl).astype(np.float32)
                        pt = (pt + ah @ bh).astype(np.float32)
                    # drains: every period chunks, and where a strip's run ends
                    run_ends = e + 1 == len(events) or events[e + 1][3] != 2
                    for wg in range(2):
                        left[wg] -= 1
                        if left[wg] == 0 or run_ends:
                            rows = slice(128 * wg, 128 * wg + 128)
                            acc[rows] = (acc[rows] + pt[rows]).astype(np.float32)
                            pt[rows] = 0.0
                            left[wg] = left0[wg] if run_ends else period
                # the epilogue: rows (group q, channel r), columns co
                for gi in np.flatnonzero(ok):
                    c = cg[gi] * 16 + r_
                    n1 = min(64, cout - co0)
                    part[slice_, co0:co0 + n1, c, tap[gi]] = acc[16 * gi:16 * gi + 16, :n1]  # (c, co)
                if mt == 0:
                    db = ((db4[:, 0] + db4[:, 1]) + db4[:, 2]) + db4[:, 3]
                    part_b[slice_, co0:co0 + 64] = db[:min(64, cout - co0)]
    dw = np.zeros((cout, cin, 9), np.float32)
    dbs = np.zeros(cout, np.float32)
    for s in range(plan.slices):  # conv3x3::reduce_rows: slices in order
        dw = (dw + part[s]).astype(np.float32)
        dbs = (dbs + part_b[s]).astype(np.float32)
    return dw.reshape(cout, cin, 3, 3), dbs


def _errors(got: np.ndarray, want: torch.Tensor) -> float:
    """max(relative L2 error, max |error| / max |want|): chip_smoke's bars."""
    ref = want.double().numpy()
    diff = got.astype(np.float64) - ref
    return max(np.linalg.norm(diff) / np.linalg.norm(ref), np.abs(diff).max() / np.abs(ref).max())


def _case(shape, seed):
    b, cin, h, w, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, h, w).astype(np.float32)
    g = rng.randn(b, cout, h, w).astype(np.float32)
    scale = (0.5 + rng.rand(cin)).astype(np.float32)
    shift = (0.05 + 0.3 * rng.rand(cin)).astype(np.float32)
    return x, g, scale, shift


# (B, Cin, H, W, Cout): a 20-wide image (chunks of 24: 4 columns past the
# image), a ragged width (44 in chunks of 48) with 27 row groups over two M
# tiles and two N tiles of 72 channels, Cin 16 (one group, 9 of 16 row
# groups) at W 12 over strips of 16
EMULATED = [(2, 32, 5, 20, 24), (1, 48, 3, 44, 72), (2, 16, 4, 12, 8)]


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_layout_matches_the_plain_version(shape, prologue):
    b, cin, h, w, cout = shape
    x, g, scale, shift = _case(shape, sum(shape))
    plan = conv_bwd.wgrad_f32_plan(b, cin, cout, h, w)
    assert plan.slices > 1 and plan.mtiles * plan.ntiles >= 1
    dw, db = emulate(x, g, scale, shift, prologue, plan)
    want = conv_bwd.wgrad3x3_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(scale), torch.from_numpy(shift), prologue)
    assert _errors(dw, want[0]) <= SUM_TOL
    assert _errors(db, want[1]) <= SUM_TOL


def test_emulated_split_k_and_strips():
    """One slice (every chunk in one block, warm-ups only at row 0), one
    slice a chunk (warm-ups before every chunk) and slices of 3 chunks with
    a ring of 5 (a drain every chunk) hold the bars; strips of 8 columns
    cover a 12-wide image."""
    shape = (2, 16, 4, 12, 8)
    x, g, scale, shift = _case(shape, 5)
    plan = conv_bwd.wgrad_f32_plan(*shape[:2], shape[4], *shape[2:4])
    want = conv_bwd.wgrad3x3_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(scale), torch.from_numpy(shift), True)
    for tw, per_slice, stages in [(plan.tw, plan.chunks, plan.stages), (8, 1, 8), (16, 3, 5)]:
        chunks = 2 * -(-12 // tw) * 4
        p = dataclasses.replace(plan, tw=tw, stage_bytes=conv_bwd.k5f_stage_bytes(tw),
                                stages=stages, chunks=chunks, per_slice=per_slice,
                                slices=-(-chunks // per_slice))
        dw, db = emulate(x, g, scale, shift, True, p)
        assert _errors(dw, want[0]) <= SUM_TOL and _errors(db, want[1]) <= SUM_TOL


def test_emulated_one_tf32_pass_misses_the_bar():
    """hi·hi alone misses the bar: the split is what makes the path
    float32-accurate."""
    shape = (2, 32, 5, 20, 24)
    x, g, scale, shift = _case(shape, 9)
    plan = conv_bwd.wgrad_f32_plan(2, 32, 24, 5, 20)
    dw, _ = emulate(x, g, scale, shift, False, plan, mode="tf32")
    want = conv_bwd.wgrad3x3_plain(torch.from_numpy(x), torch.from_numpy(g), None, None, False)
    assert _errors(dw, want[0]) > SUM_TOL
