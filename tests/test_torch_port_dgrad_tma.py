"""K6's float32 path on ``wgmma`` in 3xTF32 fed by TMA: its host-side plan
and its data layout, on the CPU.

``csrc/dgrad3x3_tma.cu`` runs only on the card. What decides and
addresses it is checked here:

- ``conv_bwd.dgrad_f32_plan``: which shapes take the TMA path (Cin a
  multiple of 64, W of 4), and that every plan fits a block's shared
  memory, covers every pixel with its tiles, and keeps a lane's A loads on
  32 distinct banks; all 13 K6 launches of the f32 ``pallas_fused`` step
  are on it;
- ``conv_bwd.dgrad_f32_uses_tma``: float32 only, 16-byte aligned tensors
  only; ``dgrad3x3_cp_async`` runs CUDA tensors only; the CPU wrapper is
  the plain version and counts nothing;
- :func:`emulate`: the kernel in numpy, one persistent block at a time:
  the weights packed as ``pack_weights_kernel`` packs them (flipped and
  transposed, tf32 hi and lo, K-major core matrices of 8 input x 4 output
  channels) and read back through the consumers' descriptors (LBO 128
  bytes, SBO 256), the cotangent's boxes as TMA lands them ([8][ROWS][HC]
  from (x0 - 4, y0 - 1), zero outside the tensor), each lane's A at its
  pixel and tap offset, split into hi and lo (tf32 as the low 13 bits
  cleared: after rounding for hi, as ``tc::split`` does, by truncation for
  lo, as the tensor core reads it), the three TF32 products into each
  consumer warpgroup's partial, drained into its sums in f32 every 2 chunks
  (the two warpgroups a chunk apart) and at a tile's end, the epilogue's
  mask, dx and the
  per-thread sums of (dam * x, dam) in the kernel's order (a thread's
  pixels, the lanes' butterfly, the warps' slots over the block's tiles,
  the warps in order, the blocks in order: ``conv3x3::reduce_rows``). It is
  held to ``dgrad3x3_plain`` within the k6 bars (3e-5 on dx, 1e-4 on the
  reductions) on ragged shapes with and without the prologue; one TF32
  pass misses them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from im2im_uq_tpu_torch.ops import conv_bwd
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

SMEM_BLOCK = 232448
# K6's bars against its plain version (chip_smoke.CONV_TOL, SUM_TOL)
CONV_TOL, SUM_TOL = 3e-5, 1e-4
# (B, Cin, H, W, Cout): the shapes of chip_smoke.K6_TMA_ODD_SHAPES
ODD_SHAPES = [(2, 64, 13, 20, 24), (3, 64, 21, 40, 16), (1, 64, 1, 4, 8), (2, 192, 17, 36, 40),
              (2, 64, 30, 28, 8)]
# K6's launches of the f32 pallas_fused UNet step at batch 32, 320x320, and
# WNet's that the plan takes
STEP_SHAPES = [(32, 64, 320, 320, 64), (32, 64, 160, 160, 128), (32, 128, 160, 160, 128),
               (32, 128, 80, 80, 256), (32, 256, 80, 80, 256), (32, 256, 40, 40, 512),
               (32, 512, 40, 40, 512), (32, 512, 20, 20, 512), (32, 512, 40, 40, 256),
               (32, 256, 80, 80, 128), (32, 128, 160, 160, 64), (32, 64, 80, 80, 128),
               (32, 128, 40, 40, 256), (32, 256, 20, 20, 256)]


def test_plan_takes_64_channel_slices_and_16_byte_rows_only():
    # the stem, Cin off the 64-channel slices, W off TMA's 16-byte rows
    for b, cin, h, w, cout in [(2, 1, 1, 1, 8), (1, 3, 5, 7, 16), (2, 64, 13, 17, 24),
                               (1, 64, 5, 7, 64), (1, 32, 320, 320, 32), (1, 96, 8, 8, 8),
                               (1, 64, 8, 6, 8), (1, 0, 8, 8, 8), (1, 64, 8, 8, 0)]:
        assert conv_bwd.dgrad_f32_plan(b, cin, cout, h, w) is None, (b, cin, h, w, cout)
    for b, cin, h, w, cout in [(1, 64, 1, 4, 1), (1, 128, 160, 160, 128), (1, 1024, 9, 500, 3)
                               ] + ODD_SHAPES + STEP_SHAPES:
        assert conv_bwd.dgrad_f32_plan(b, cin, cout, h, w) is not None, (b, cin, h, w, cout)


def _bank_sets(plan) -> list:
    """The banks of each A load of each consumer warp (at tap (0, 0) and
    channel 0: the taps and channels add a constant), as the kernel's lane
    offsets give them."""
    npx, out = plan.th * plan.tw, []
    cs = plan.rows * plan.hc
    for cw in range(8):
        wg, wq = divmod(cw, 4)
        for i in range(2):
            for u in range(2):
                for k4 in range(2):
                    banks = set()
                    for lane in range(32):
                        gid, tig = divmod(lane, 4)
                        p = 128 * wg + 64 * i + 16 * wq + gid + 8 * u
                        off = (p // plan.tw * plan.hc + p % plan.tw + 3 if p < npx else 0)
                        banks.add((off + (tig + 4 * k4) * cs) % 32)
                    # a load whose 8 pixels all lie in the tile
                    if all(128 * wg + 64 * i + 16 * wq + 8 * u + g < npx for g in range(8)):
                        out.append(banks)
    return out


@pytest.mark.parametrize("shape", STEP_SHAPES + ODD_SHAPES + [
    (1, 64, 1, 4, 1), (1, 1024, 9, 500, 3), (64, 64, 2, 12, 8), (1, 64, 300, 4, 8),
    (1, 64, 1, 248, 8), (2, 64, 5, 496, 8)])
def test_every_plan_fits_a_block_covers_the_image_and_loads_on_32_banks(shape):
    b, cin, h, w, cout = shape
    p = conv_bwd.dgrad_f32_plan(b, cin, cout, h, w)
    assert p.th * p.tw <= 256 and p.th <= h and p.tw % 4 == 0
    assert p.tiles == b * -(-h // p.th) * -(-w // p.tw)  # every pixel in one tile
    # the box: from x0 - 4 past x0 + tw, from y0 - 1 past y0 + th, 16-byte rows
    assert p.hc in (p.tw + 8, p.tw + 12) and p.rows >= p.th + 2 and p.hc <= 256 >= p.rows
    assert p.box_bytes == 8 * p.rows * p.hc * 4
    assert p.stage_bytes == -(-p.box_bytes // 128) * 128 + 18 * 64 * 8 * 4
    # the ring, its two mbarriers a stage and the warps' reduction slots
    assert p.smem == p.stages * (p.stage_bytes + 16) + 8 * 64 * 2 * 4 <= SMEM_BLOCK
    assert 2 <= p.stages <= 4
    assert p.ntn == cin // 64 and 1 <= p.per_slice <= p.tiles and p.blocks <= 132
    # a lane's 4 channels 8 banks apart, its warp's 8 pixels on 8 more
    assert p.rows * p.hc % 16 == 8
    assert all(len(banks) == 32 for banks in _bank_sets(p))


def test_the_box_stays_within_tma_limits():
    """A tile 248 wide would need a box of 260 columns (248 + 8 is a
    multiple of 16, so no plane is an odd multiple of 8): no plan takes it."""
    assert conv_bwd.k6f_box(1, 248) is None and conv_bwd.k6f_box(1, 240) == (248, 3)
    for w in range(4, 1025, 4):
        for h in (1, 5, 40):
            p = conv_bwd.dgrad_f32_plan(1, 64, 8, h, w)
            assert p.hc <= 256 and p.rows <= 256, (h, w, p)


def test_plan_tiles_at_the_step_levels():
    # no padding at 320 to 80; 40 and 20 pad 10.7% and 21.9% (tiles of 256)
    for side, th, tw in [(320, 8, 32), (160, 8, 32), (80, 16, 16), (40, 6, 40), (20, 12, 20)]:
        p = conv_bwd.dgrad_f32_plan(32, 512, 512, side, side)
        assert (p.th, p.tw, p.stages) == (th, tw, 4), (side, p)
        assert p.tiles == 32 * -(-side // th) * -(-side // tw)
    # one persistent block per SM, the slices side by side
    for cin, blocks in [(64, 132), (128, 132), (256, 132), (512, 128)]:
        assert conv_bwd.dgrad_f32_plan(32, cin, 64, 320, 320).blocks == blocks


def test_the_fused_step_runs_all_13_k6_launches_on_the_tma_path():
    """``chip_smoke.require_tma_per_step``'s K6 count: one K6 a K4 of the
    f32 pallas_fused step at batch 32, 320x320 but the stem's, all on the
    plan."""
    import chip_smoke

    sites = chip_smoke.conv_sites("pallas_fused")["dgrad3x3"]
    planned = [s for s, _ in sites if conv_bwd.dgrad_f32_plan(s[0], s[1], s[4], s[2], s[3])]
    assert len(sites) == len(planned) == 13


def test_uses_tma_for_aligned_f32_only():
    x = torch.zeros((1, 1, 1, 1)).expand(32, 64, 320, 320)  # the shape without its memory
    g = torch.zeros((1, 1, 1, 1)).expand(32, 64, 320, 320)
    assert conv_bwd.dgrad_f32_uses_tma(g, x)
    assert not conv_bwd.dgrad_f32_uses_tma(g.to(torch.bfloat16), x.to(torch.bfloat16))
    shifted = torch.zeros(8 * 4 * 4 + 1)[1:].view(1, 8, 4, 4)
    assert not conv_bwd.dgrad_f32_uses_tma(shifted, torch.zeros((1, 64, 4, 4)))
    shifted_x = torch.zeros(64 * 4 * 4 + 1)[1:].view(1, 64, 4, 4)
    assert not conv_bwd.dgrad_f32_uses_tma(torch.zeros((1, 8, 4, 4)), shifted_x)
    assert conv_bwd.dgrad_f32_uses_tma(torch.zeros((1, 8, 4, 4)), torch.zeros((1, 64, 4, 4)))
    assert not conv_bwd.dgrad_f32_uses_tma(torch.zeros((1, 8, 4, 4)), torch.zeros((1, 32, 4, 4)))
    assert not conv_bwd.dgrad_f32_uses_tma(torch.zeros((1, 8, 4, 6)), torch.zeros((1, 64, 4, 6)))


def test_cp_async_runs_cuda_tensors_only():
    """The comparison path launches its kernel or raises: no plain version."""
    g, x, w = torch.zeros((1, 8, 4, 4)), torch.zeros((1, 64, 4, 4)), torch.zeros((8, 64, 3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_bwd.dgrad3x3_cp_async(g, x, w, None, None, False)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.randn(1, 8, 5, 8).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 64, 5, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 64, 3, 3).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(64)).astype(np.float32))
    shift = torch.from_numpy((0.3 * rng.rand(64)).astype(np.float32))
    before = (conv_bwd.dgrad3x3.launches, conv_bwd.dgrad3x3.tma.launches)
    got = conv_bwd.dgrad3x3(g, x, w, scale, shift, True)
    want = conv_bwd.dgrad3x3_plain(g, x, w, scale, shift, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (conv_bwd.dgrad3x3.launches, conv_bwd.dgrad3x3.tma.launches) == before


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::k6f::dgrad3x3_tma_kernel<true>(CUtensorMap_st, float const*, "
    "(anonymous namespace)::k6f::Geo)",
    "_ZN48_GLOBAL__N__0fece372_15_dgrad3x3_tma_cu_6d30eace3k6f19dgrad3x3_tma_kernelILb0EEEv14"
    "CUtensorMap_stPKfNS0_3GeoE",
    "void (anonymous namespace)::k6f::pack_weights_kernel(float const*, float*, int, int, int, "
    "long)"])
def test_profile_bucket_of_the_tma_kernel(name):
    from im2im_uq_tpu_torch.utils import profiling

    assert profiling.bucket(name) == "K6 dgrad3x3 (port)"


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


def pack_weights(w: np.ndarray) -> np.ndarray:
    """``pack_weights_kernel``: [slice][chunk][tap][hi, lo][c group][co
    half][8 c][4 co] of W[co, c, 8 - tap], 0 past Cout."""
    cout, cin = w.shape[:2]
    nch = -(-cout // 8)
    wp = np.zeros((nch * 8, cin, 9), np.float32)
    wp[:cout] = w.reshape(cout, cin, 9)[:, :, ::-1]  # tap t reads W[..., 8 - t]
    # [co chunk][co half][4 co][c slice][c group][8 c][tap]
    v = wp.reshape(nch, 2, 4, cin // 64, 8, 8, 9)
    hi, lo = _split(v)
    both = np.stack([hi, lo])  # [part][chunk][half][k4][slice][group][n8][tap]
    return np.ascontiguousarray(both.transpose(4, 1, 7, 0, 5, 2, 6, 3)).ravel()


def emulate(g: np.ndarray, x: np.ndarray, w: np.ndarray, scale, shift, prologue: bool,
            plan: conv_bwd.DgradF32Plan, mode: str = "3xtf32") -> tuple:
    """``dgrad3x3_tma_kernel`` and the sums over its blocks, by its own
    layouts (see the module docstring) → (dx, red). mode "tf32": one
    pass, hi·hi alone."""
    b, cout, h, w_ = g.shape
    cin = x.shape[1]
    th, tw, hc, rows = plan.th, plan.tw, plan.hc, plan.rows
    cs = rows * hc
    nch = -(-cout // 8)
    wpack = pack_weights(w)
    wchunk = 18 * 64 * 8  # floats
    # g with TMA's zero fill around it: a box from (x0 - 4, y0 - 1) at [.., 1:, 4:]
    tiles_y, tiles_x = -(-h // th), -(-w_ // tw)
    gpad = np.zeros((b, nch * 8, tiles_y * th + rows, tiles_x * tw + hc), np.float32)
    gpad[:, :cout, 1:h + 1, 4:w_ + 4] = g
    # the lanes' A offsets in a box at tap (0, 0), channel 0, for tile rows p
    p_ = np.arange(256)
    npx = th * tw
    poff = np.where(p_ < npx, p_ // tw * hc + p_ % tw + 3, 0)
    k_ = np.arange(8)
    n_ = np.arange(64)
    # B (8 co x 64 c) of one tap from its descriptor: LBO 128 bytes between
    # co halves, SBO 256 between c groups, 16-byte rows of 4 co
    boff = (n_[None, :] // 8) * 64 + (k_[:, None] // 4) * 32 + (n_[None, :] % 8) * 4 + k_[:, None] % 4
    dx = np.zeros(x.shape, np.float32)
    part = np.zeros((plan.per_slice, 2, cin), np.float32)
    for ns in range(plan.ntn):
        wslice = wpack[ns * nch * wchunk:(ns + 1) * nch * wchunk]
        for first in range(plan.per_slice):
            slots = np.zeros((8, 64, 2), np.float32)  # [warp][channel][2]
            left0 = [2, 1]  # chunks to each warpgroup's first drain in a tile
            left = list(left0)
            for t in range(first, plan.tiles, plan.per_slice):
                bi, r = divmod(t, tiles_y * tiles_x)
                ty, tx = divmod(r, tiles_x)
                y0, x0 = ty * th, tx * tw
                acc = np.zeros((256, 64), np.float32)
                pt = np.zeros((256, 64), np.float32)
                for c in range(nch):
                    box = gpad[bi, 8 * c:8 * c + 8, y0:y0 + rows, x0:x0 + hc].ravel()
                    wc = wslice[c * wchunk:(c + 1) * wchunk]
                    for tap in range(9):
                        # A (256 pixels x 8 co) at the tap's offset
                        a = box[poff[:, None] + k_[None, :] * cs + tap // 3 * hc + tap % 3]
                        ah, al = _split(a)
                        al = _tf32_trunc(al)
                        bh = wc[(2 * tap) * 512 + boff]
                        bl = _tf32_trunc(wc[(2 * tap + 1) * 512 + boff])
                        if mode == "tf32":
                            pt = (pt + ah @ bh).astype(np.float32)
                            continue
                        pt = (pt + al @ bh).astype(np.float32)
                        pt = (pt + ah @ bl).astype(np.float32)
                        pt = (pt + ah @ bh).astype(np.float32)
                    # the drains: warpgroup wg's rows 128 wg .. 128 wg + 127
                    last = c + 1 == nch
                    for wg in range(2):
                        left[wg] -= 1
                        if left[wg] == 0 or last:
                            rows_ = slice(128 * wg, 128 * wg + 128)
                            acc[rows_] = (acc[rows_] + pt[rows_]).astype(np.float32)
                            pt[rows_] = 0.0
                            left[wg] = left0[wg] if last else 2
                # the epilogue: pixel p, channel 64 ns + n
                py, px = p_ // tw, p_ % tw
                yy, xx = y0 + py, x0 + px
                inside = (p_ < npx) & (yy < h) & (xx < w_)
                cc = 64 * ns + n_
                if not prologue:
                    dx[bi, cc[None, :], yy[inside, None], xx[inside, None]] = acc[inside]
                    continue
                xv = np.zeros((256, 64), np.float32)
                xv[inside] = x[bi, cc[None, :], yy[inside, None], xx[inside, None]]
                sc, sh = scale[cc], shift[cc]
                keep = inside[:, None] & ((xv * sc).astype(np.float32) + sh > 0)
                dam = np.where(keep, acc, np.float32(0))
                dx[bi, cc[None, :], yy[inside, None], xx[inside, None]] = (dam * sc)[inside]
                # each thread's sums over its pixels (i, then u), fmaf for Σ dam·x
                s = np.zeros((8, 8, 64, 2), np.float32)  # [warp][gid][channel][2]
                for cw in range(8):
                    wg, wq = divmod(cw, 4)
                    for i in range(2):
                        for u in range(2):
                            pp = 128 * wg + 64 * i + 16 * wq + np.arange(8) + 8 * u
                            prod = dam[pp].astype(np.float64) * xv[pp] + s[cw, :, :, 0]
                            s[cw, :, :, 0] = prod.astype(np.float32)
                            s[cw, :, :, 1] = (s[cw, :, :, 1] + dam[pp]).astype(np.float32)
                # the lanes' butterfly over gid (xor 1, 2, 4), then the slots
                for m in (1, 2, 4):
                    s = (s + s[:, np.arange(8) ^ m]).astype(np.float32)
                slots = (slots + s[:, 0]).astype(np.float32)
            # the block's partial: the warps' slots in order
            tot = np.zeros((64, 2), np.float32)
            for cw in range(8):
                tot = (tot + slots[cw]).astype(np.float32)
            part[first, :, 64 * ns:64 * ns + 64] = tot.T
    red = np.zeros((2, cin), np.float32)
    if prologue:
        for first in range(plan.per_slice):  # conv3x3::reduce_rows: blocks in order
            red = (red + part[first]).astype(np.float32)
    return dx, red


def _errors(got: np.ndarray, want: torch.Tensor) -> float:
    """max(relative L2 error, max |error| / max |want|): chip_smoke's bars."""
    ref = want.double().numpy()
    diff = got.astype(np.float64) - ref
    if not np.abs(ref).max():
        return float(np.abs(diff).max())
    return max(np.linalg.norm(diff) / np.linalg.norm(ref), np.abs(diff).max() / np.abs(ref).max())


def _case(shape, seed):
    b, cin, h, w, cout = shape
    rng = np.random.RandomState(seed)
    g = rng.randn(b, cout, h, w).astype(np.float32)
    x = rng.randn(b, cin, h, w).astype(np.float32)
    wt = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    scale = (0.5 + rng.rand(cin)).astype(np.float32)
    shift = (0.05 + 0.3 * rng.rand(cin)).astype(np.float32)
    return g, x, wt, scale, shift


def _plain(g, x, wt, scale, shift, prologue):
    t = [torch.from_numpy(a) for a in (g, x, wt, scale, shift)]
    return conv_bwd.dgrad3x3_plain(*t, prologue)


def test_packed_weights_are_the_flipped_transposed_kernel_split():
    """Packed tap t of (co, c) is W[co, c, 8 - t]: hi + lo gives it back,
    hi has tf32's 10 mantissa bits, 0 past Cout."""
    rng = np.random.RandomState(4)
    w = rng.randn(12, 128, 3, 3).astype(np.float32)
    v = pack_weights(w).reshape(2, 2, 9, 2, 8, 2, 8, 4)  # [slice][chunk][tap][part][grp][half][n][k]
    hi, lo = v[:, :, :, 0], v[:, :, :, 1]
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    whole = (hi + lo).transpose(1, 4, 6, 0, 3, 5, 2).reshape(16, 128, 9)  # [co][c][tap]
    assert np.array_equal(whole[:12], w.reshape(12, 128, 9)[:, :, ::-1])
    assert not whole[12:].any()


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 13, 20, 24), (1, 64, 1, 4, 8), (2, 128, 9, 28, 12)])
def test_emulated_layout_matches_the_plain_version(shape, prologue):
    b, cin, h, w, cout = shape
    g, x, wt, scale, shift = _case(shape, sum(shape))
    plan = conv_bwd.dgrad_f32_plan(b, cin, cout, h, w, sms=4)  # several tiles a block
    dx, red = emulate(g, x, wt, scale, shift, prologue, plan)
    want = _plain(g, x, wt, scale, shift, prologue)
    assert _errors(dx, want[0]) <= CONV_TOL
    assert _errors(red, want[1]) <= SUM_TOL


def test_emulated_ragged_tiles_and_slices():
    """Tiles of 16 x 16 over a 30 x 28 image (the last 14 rows, 12
    columns), Cout 40 in 5 chunks, two N slices walked by 3 blocks each."""
    shape = (1, 128, 30, 28, 40)
    g, x, wt, scale, shift = _case(shape, 11)
    plan = conv_bwd.dgrad_f32_plan(1, 128, 40, 30, 28, sms=6)
    assert (plan.th, plan.tw, plan.ntn, plan.per_slice) == (16, 16, 2, 3)
    dx, red = emulate(g, x, wt, scale, shift, True, plan)
    want = _plain(g, x, wt, scale, shift, True)
    assert _errors(dx, want[0]) <= CONV_TOL and _errors(red, want[1]) <= SUM_TOL


def test_emulated_one_tf32_pass_misses_the_bar():
    """hi·hi alone misses the bar: the split is what makes the path
    float32-accurate."""
    shape = (2, 64, 13, 20, 24)
    g, x, wt, scale, shift = _case(shape, 9)
    plan = conv_bwd.dgrad_f32_plan(2, 64, 24, 13, 20)
    dx, _ = emulate(g, x, wt, scale, shift, False, plan, mode="tf32")
    want = _plain(g, x, wt, scale, shift, False)
    assert _errors(dx, want[0]) > CONV_TOL
