"""K3 and K4 in bf16 on K6's ``wgmma`` core over an NHWC copy of x: the
activation pass's plain version, the plan and the kernel's addressing, on
the CPU.

``csrc/conv3x3_bf16.cu`` runs only on the card. What decides and addresses
its forward instance (``k6::conv3x3_fwd_wgmma_kernel``) is checked here:

- ``conv_bwd.activation_plain`` (the activation pass's plain version) bit
  for bit against the bf16 activation that ``test_torch_port_bf16.py``
  holds K4's plain version to ``_conv3x3_fused_raw`` in interpret mode with
  (bf16(relu(f32(x)·scale + shift)), the product and the sum each rounded),
  and against the JAX package's prologue expression (``pallas_conv.py:155-160``)
  run op by op;
- ``conv_plan`` at every bf16 K3/K4 launch of the batch-32 320x320 paths
  (``chip_smoke.bf16_conv_sites``, the stem aside): tiles that cover the
  image, the ring within a block's 232,448 bytes, M a whole number of m64
  instances, N a ``wgmma`` width, 2-4 stages, one block per SM;
- ``chip_smoke.activation_sites``: the activation pass's launches in each
  bf16 main path, one for each K3/K4 call and each K5 beyond the stem;
- ``pack_weights``: ``pack_weights_k6``'s index arithmetic in numpy, its B
  tiles the forward's unflipped W[n][k][tap] and K6's flipped, transposed
  W[k][n][8 - tap];
- :func:`emulate_fwd`: the kernel's flattened-halo addressing over the NHWC
  copy and the packed weights, its bias, rounding and per-tile stats rows
  summed per image, in f64 against ``conv3x3_bn_act_plain`` in f64 (1e-12)
  and in f32 arithmetic on bf16 inputs against the bf16 plain version
  within ``chip_smoke.k34_bf16_over``'s bars, prologue and stats on and
  off, at W % 8 == 0 (the TMA epilogue) and W % 8 != 0.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from im2im_uq_tpu_torch.ops import conv as tconv
from im2im_uq_tpu_torch.ops import conv_bwd
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
SMEM_BLOCK, SMS = 232448, 132
# (B, Cin, H, W, Cout) of the bf16 K3/K4 launches beyond the stem at batch
# 32, 320x320: the bf16 `pallas` step's K3 and the `pallas_fused` eval
# forward's K3 and K4
SITES = [(32, 64, 320, 320, 64), (32, 64, 160, 160, 128), (32, 128, 160, 160, 128),
         (32, 128, 80, 80, 256), (32, 256, 80, 80, 256), (32, 256, 40, 40, 512),
         (32, 512, 40, 40, 512), (32, 512, 20, 20, 512), (32, 512, 40, 40, 256),
         (32, 256, 80, 80, 128), (32, 128, 160, 160, 64)]


def test_sites_are_chip_smokes():
    sites = chip_smoke.bf16_conv_sites()
    got = {shape for kernel in ("conv3x3_bf16", "conv3x3_bn_act_bf16")
           for counts in sites[kernel].values() for shape, _ in counts if shape[1] > 1}
    assert got == set(SITES)


def test_activation_sites_are_one_pass_a_k3_k4_or_k5_beyond_the_stem():
    """``chip_smoke.activation_sites``: the ``pallas`` step's 21 K3 calls
    beyond the stem, the fused eval forward's 8 K3 and 13 K4 calls (9 with
    the prologue, one a DoubleConv's conv1), and the fused train step's
    forward plus one pass for each of its 13 K5 calls beyond the stem, each
    on its conv's x with its conv's prologue."""
    paths = chip_smoke.activation_sites()
    totals = {path: (sum(c.values()), sum(n for (_, p), n in c.items() if p))
              for path, c in paths.items()}
    assert totals == {"pallas": (21, 0), "pallas_fused_eval": (21, 9), "pallas_fused": (34, 18)}
    inputs = {((b, cin, h, w), p) for (b, cin, h, w, _) in SITES for p in (True, False)}
    for counts in paths.values():
        assert set(counts) <= inputs
    k5 = paths["pallas_fused"] - paths["pallas_fused_eval"]
    assert paths["pallas_fused_eval"] <= paths["pallas_fused"]
    assert set(k5) <= set(paths["pallas_fused_eval"]) and sum(k5.values()) == 13


@pytest.mark.parametrize("shape", SITES)
def test_conv_plan_at_the_bf16_sites(shape):
    b, cin, h, w, cout = shape
    p = conv_bwd.conv_plan(b, cin, cout, h, w)
    mt = 64 * (4 if p.bn == 64 else 2) * 2  # two warpgroups of m64 instances
    hc = p.tw + 2
    assert p.bn in (64, 128) and p.bn % 8 == 0 and p.ntn == -(-cout // p.bn)
    assert p.chunks == -(-conv_bwd.padded_channels(cin) // 16)  # K: k16 steps
    assert 2 <= p.stages <= 4
    sums = 2 * 8 * p.bn * 2 * 4  # two [warp][N][2] buffers of a tile's stats
    assert p.smem == p.stages * p.stage_bytes + 16 * p.stages + sums + p.xs_bytes + 16
    assert p.smem <= SMEM_BLOCK
    assert (p.th - 1) * hc + p.tw <= mt  # the tile's positions fit the M rows
    assert hc <= 256 and p.th + 2 <= 256  # the x box
    assert p.plane >= max((p.th + 2) * hc, mt + 2 * hc + 2) * 16 and p.plane % 128 == 0
    assert (mt - 1 + 2 * hc + 2) * 16 <= p.plane  # the last row's last tap reads inside
    assert -(-h // p.th) * p.th >= h and -(-w // p.tw) * p.tw >= w
    assert -(-h // p.th) * -(-w // p.tw) * b == p.tiles
    # y by one TMA store at every level but 20x20 (whose rows are 40 bytes)
    assert (p.xs_bytes > 0) == (w % 8 == 0 and p.tw % 8 == 0) == (w != 20)
    assert p.blocks == SMS and p.blocks % p.ntn == 0  # one block per SM
    assert p.tiles / (-(-p.tiles // p.per_slice) * p.per_slice) >= 0.75  # blocks' last round


def _bf16(shape, seed, scale=1.0) -> torch.Tensor:
    return (scale * torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32))).to(BF16)


@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 3, 17, 19), (2, 13, 20, 20)])
def test_activation_plain_is_k4s_bf16_activation(shape, prologue):
    x = _bf16(shape, 0)
    c = shape[1]
    rng = np.random.RandomState(1)
    scale = torch.from_numpy((0.5 + rng.rand(c)).astype(np.float32))
    shift = torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32))
    got = conv_bwd.activation_plain(x, scale, shift, prologue)
    assert got.dtype == BF16 and got.shape == (*x.shape[:1], *x.shape[2:],
                                               conv_bwd.padded_channels(c))
    assert not got[..., c:].any()
    # the activation test_k4_bf16_plain_matches_pallas_interpret holds the
    # plain K4 to the Pallas kernel with
    want = conv_bwd.prologue_activation(x.float(), scale, shift, prologue).to(BF16)
    assert torch.equal(got[..., :c], want.permute(0, 2, 3, 1))
    # pallas_conv.py:155-160 op by op (no contraction into an FMA)
    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
    if prologue:
        u = xj.astype(jnp.float32) * jnp.asarray(scale.numpy())
        xj = jnp.maximum(u + jnp.asarray(shift.numpy()), 0.0).astype(jnp.bfloat16)
    assert np.array_equal(got[..., :c].float().numpy(), np.asarray(xj.astype(jnp.float32)))


def pack_weights(w: np.ndarray, kdim: int, ndim: int, bn: int, nch: int, flip: bool) -> np.ndarray:
    """``pack_weights_k6`` in numpy: element i of wpack decomposed as the
    kernel does, [slice][chunk][tap][n group][k half][8 n][8 k], its value
    W[k][n][8 - tap] of a (K, N, 3, 3) weight with ``flip``, else
    W[n][k][tap] of an (N, K, 3, 3) one; 0 past kdim and ndim."""
    ntn = -(-ndim // bn)
    ns, ch, tap, ng, kh, n8, k8 = np.unravel_index(np.arange(ntn * nch * 9 * 16 * bn),
                                                   (ntn, nch, 9, bn // 8, 2, 8, 8))
    k, n = ch * 16 + kh * 8 + k8, ns * bn + ng * 8 + n8
    ok = (k < kdim) & (n < ndim)
    flat = w.reshape(-1)
    src = np.where(flip, (k * ndim + n) * 9 + 8 - tap, (n * kdim + k) * 9 + tap)
    return np.where(ok, flat[np.where(ok, src, 0)], 0.0).astype(w.dtype)


def b_tile(wpack: np.ndarray, bn: int, nch: int, ns: int, ch: int, tap: int) -> np.ndarray:
    """The (16 k x bn n) B operand that wgmma reads for (slice, chunk, tap):
    core matrices of 8 n x 8 k, k halves 128 bytes apart, n groups 256."""
    t = wpack.reshape(-1, nch, 9, bn // 8, 2, 8, 8)[ns, ch, tap]  # [ng][kh][n8][k8]
    return t.transpose(1, 3, 0, 2).reshape(16, bn)


@pytest.mark.parametrize("flip", [False, True])
def test_pack_weights_tiles_are_the_conv_and_its_transpose(flip):
    kdim, ndim, bn = 40, 136, 128
    nch = -(-kdim // 16)
    w = np.random.RandomState(2).randn(*((kdim, ndim) if flip else (ndim, kdim)), 3, 3)
    wpack = pack_weights(w, kdim, ndim, bn, nch, flip)
    for ns in range(-(-ndim // bn)):
        for ch in range(nch):
            for tap in range(9):
                k = np.arange(16)[:, None] + 16 * ch
                n = np.arange(bn)[None, :] + bn * ns
                ok = (k < kdim) & (n < ndim)
                kc, nc = np.minimum(k, kdim - 1), np.minimum(n, ndim - 1)
                want = (w[kc, nc, (8 - tap) // 3, (8 - tap) % 3] if flip
                        else w[nc, kc, tap // 3, tap % 3])
                np.testing.assert_array_equal(b_tile(wpack, bn, nch, ns, ch, tap),
                                              np.where(ok, want, 0.0))


def emulate_fwd(xp: np.ndarray, w: np.ndarray, bias: np.ndarray | None, plan, stats: bool,
                rounding=None) -> tuple[np.ndarray, np.ndarray]:
    """The forward kernel as it addresses its operands: per tile (tiles in
    order) the haloed box of the NHWC copy ``xp`` (0 outside the image and
    past its channels, as TMA fills it) flattened over HC = tw + 2 columns,
    M rows m read at m + dh·HC + dw for tap (dh, dw) against the packed
    weights' B tiles, chunk by chunk; row m is the pixel at box position
    m + HC + 1 where that is inside the tile and the image: y = the sum
    plus the bias, ``rounding`` applied (bf16's, or none); the stats a row
    per tile over the stored values, summed per image in tile order."""
    b, h, wd, kp = xp.shape
    cout, cin = w.shape[:2]
    th, tw, bn = plan.th, plan.tw, plan.bn
    hc = tw + 2
    mt = 64 * (4 if bn == 64 else 2) * 2
    nch = -(-kp // 16)
    positions = max((th + 2) * hc, mt + 2 * hc + 2)
    wpack = pack_weights(w, cin, cout, bn, nch, False)
    dt = xp.dtype
    y = np.zeros((b, cout, h, wd), dt)
    rows = []  # [tile][2][cout]
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, wd, tw):
                box = np.zeros((positions, nch * 16), dt)
                for i in range(th + 2):
                    for j in range(hc):
                        yy, xx = y0 - 1 + i, x0 - 1 + j
                        if 0 <= yy < h and 0 <= xx < wd:
                            box[i * hc + j, :kp] = xp[bi, yy, xx]
                row = np.zeros((2, cout), dt)
                for ns in range(-(-cout // bn)):
                    acc = np.zeros((mt, bn), dt)
                    for ch in range(nch):
                        a = box[:, 16 * ch:16 * ch + 16]
                        for tap in range(9):
                            shift = tap // 3 * hc + tap % 3
                            acc += a[shift:shift + mt] @ b_tile(wpack, bn, nch, ns, ch, tap)
                    for m in range(mt):
                        rr, cc = divmod(m + hc + 1, hc)
                        rr, cc = rr - 1, cc - 1
                        if not (0 <= cc < tw and rr < th and y0 + rr < h and x0 + cc < wd):
                            continue
                        n0, n1 = ns * bn, min(cout, ns * bn + bn)
                        v = acc[m, :n1 - n0] + (bias[n0:n1] if bias is not None else 0)
                        v = rounding(v) if rounding is not None else v
                        y[bi, n0:n1, y0 + rr, x0 + cc] = v
                        row[0, n0:n1] += v
                        row[1, n0:n1] += v * v
                rows.append(row)
    per_img = len(rows) // b
    st = np.stack([sum(rows[bi * per_img:(bi + 1) * per_img]) for bi in range(b)])
    return y, (st if stats else np.zeros_like(st))


# (B, Cin, H, W, Cout, (th, tw) of another shape's plan, or None for the
# shape's own): one tile an image, W % 8 == 0 (the TMA epilogue); two
# slices of N and two tiles an image at 20x20 (W % 8 != 0); the 40x40
# levels' 6 x 40 tiles, the last one cut by the image; 10 tiles of 7 x 64;
# Cin 3 (a chunk's second group past the channels) at 17x19
EMULATED = [(2, 20, 16, 16, 24, None), (1, 24, 20, 20, 136, None),
            (2, 16, 40, 40, 24, (32, 512, 40, 40, 512)), (1, 8, 64, 64, 16, None),
            (1, 3, 17, 19, 8, None)]


def _plan(shape, main):
    b, cin, h, w, cout = shape
    own = conv_bwd.conv_plan(b, cin, cout, h, w)
    if main is None:
        return own
    ref = conv_bwd.conv_plan(*main[:2], main[4], *main[2:4])
    return dataclasses.replace(own, th=ref.th, tw=ref.tw)


def _inputs(shape, dtype):
    b, cin, h, w, cout = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, cin, h, w)).to(dtype)
    wt = torch.from_numpy(rng.randn(cout, cin, 3, 3) / (9 * cin) ** 0.5).to(dtype)
    bias = torch.from_numpy(0.1 * rng.randn(cout)).to(dtype)
    scale = torch.from_numpy(0.5 + rng.rand(cin)).float()
    shift = torch.from_numpy(0.05 + 0.3 * rng.rand(cin)).float()
    return x, wt, bias, scale, shift


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("case", EMULATED)
def test_k3_k4_addressing_emulated_in_f64(case, prologue, stats):
    *shape, main = case
    plan = _plan(shape, main)
    x, wt, bias, scale, shift = _inputs(shape, torch.float64)
    want_y, want_st = tconv.conv3x3_bn_act_plain(x, wt, bias, scale.double(), shift.double(),
                                                 prologue, stats)
    xp = conv_bwd.activation_plain(x, scale.double(), shift.double(), prologue).numpy()
    y, st = emulate_fwd(xp, wt.numpy(), bias.numpy(), plan, stats)
    np.testing.assert_allclose(y, want_y.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st, want_st.numpy(), rtol=1e-12, atol=1e-10)


def _round_bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v)).to(BF16).float().numpy()


@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("prologue", [True, False])
@pytest.mark.parametrize("case", EMULATED[1:3])
def test_k3_k4_emulated_in_f32_holds_the_bf16_bars(case, prologue, stats):
    """The kernel's function in f32 arithmetic on bf16 inputs: the sum of
    exact bf16 products in f32 plus the bias, rounded once to bf16, the
    stats over the rounded y; against the bf16 plain version (which sums in
    another order) within the bars that chip_smoke.py holds the card to."""
    *shape, main = case
    plan = _plan(shape, main)
    x, wt, bias, scale, shift = _inputs(shape, BF16)
    want = tconv.conv3x3_bn_act_plain(x, wt, bias, scale, shift, prologue, stats)
    xp = conv_bwd.activation_plain(x, scale, shift, prologue)
    y, st = emulate_fwd(xp.float().numpy(), wt.float().numpy(), bias.float().numpy(), plan,
                        stats, _round_bf16)
    got = (torch.from_numpy(y).to(BF16), torch.from_numpy(st))
    assert torch.equal(got[0].float(), torch.from_numpy(y))  # y is bf16-valued
    act = xp[..., :shape[1]].permute(0, 3, 1, 2)
    y_over, st_over = chip_smoke.k34_bf16_over(got, want, act, wt)
    assert y_over == 0
    assert st_over == 0 if stats else not got[1].any()


def test_bf16_wrappers_take_the_plain_versions_on_the_cpu():
    x, wt, bias, scale, shift = _inputs((2, 5, 6, 7, 16), BF16)
    before = (tconv.conv3x3.bf16.launches, tconv.conv3x3_bn_act.bf16.launches,
              conv_bwd.activation_nhwc.launches)
    assert torch.equal(conv_bwd.activation_nhwc(x, scale, shift, True),
                       conv_bwd.activation_plain(x, scale, shift, True))
    assert torch.equal(tconv.conv3x3_fwd(x, wt, bias), tconv.conv3x3_plain(x, wt, bias))
    for got, want in zip(tconv.conv3x3_bn_act_fwd(x, wt, bias, scale, shift, True, True),
                         tconv.conv3x3_bn_act_plain(x, wt, bias, scale, shift, True, True)):
        assert torch.equal(got, want)
    assert (tconv.conv3x3.bf16.launches, tconv.conv3x3_bn_act.bf16.launches,
            conv_bwd.activation_nhwc.launches) == before
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        conv_bwd.activation_nhwc(torch.empty((1, 2, 3, 4), device="meta"), None, None, False)
