"""Why K3-K6 split every operand for the tensor cores (3xTF32).

K3/K4 (``csrc/conv3x3.cu``), K5 (``csrc/wgrad3x3.cu``) and K6
(``csrc/dgrad3x3.cu``) run their GEMMs on the tensor cores with TF32
operands (10 explicit mantissa bits). Here, in plain torch on the CPU, TF32
rounding is emulated on an int32 view of the float32 bits, and the GEMMs of
a small conv (K5, K6: B = 2, Cin = Cout = 64, 16x16; K3, K4: a deep K, B =
1, 8x8, Cin = 512, Cout = 64, in the kernels' chunks of 8 input channels x
9 taps, each chunk through a fresh accumulator; with and without the
prologue) are computed

- in one TF32 pass: tf32(a)·tf32(b), float32 accumulation;
- in 3xTF32, as the kernels do: hi = tf32(v) for each operand, lo = v − hi
  truncated to TF32 (the tensor core reads only the top 19 bits of a TF32
  operand), lo·hi + hi·lo + hi·hi, float32 accumulation;

and held against the plain versions in float64 with the bars that
``chip_smoke.py`` holds the kernels to on the card (relative L2 and
max|error| / max|reference|): ``CONV_TOL`` on K3's and K4's y and K6's dx,
``SUM_TOL`` on K4's stats, K5's dW and db and K6's reductions. 3xTF32 stays inside them; one TF32 pass
does not. TF32 products of two 11-bit significands are exact in float32,
so a float32 matmul of TF32-rounded operands is the tensor core's product.
The kernels round hi with ties away from zero (``cvt.rna``'s rule, by an
integer add on the bit pattern); both tie rules are emulated, and they
agree away from exact ties.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import CONV_TOL, PEAK_BYTES_PER_S, SUM_TOL, conv_bound
from im2im_uq_tpu_torch.ops import conv, conv_bwd
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

B, C, S = 2, 64, 16
# K3/K4's case: K = 9 * 512, the depth of the UNet's deepest convs
FB, FCIN, FS, FCOUT = 1, 512, 8, 64
CHUNK = 8  # input channels per chunk of the kernels' K (x 9 taps)
TIES = ["even", "away"]


def tf32(v: torch.Tensor, tie: str) -> torch.Tensor:
    """float32 → the nearest TF32 value (13 low mantissa bits cleared),
    rounded on the int32 view; ``tie`` is "even" or "away" (from zero)."""
    bits = v.contiguous().view(torch.int32)
    if tie == "even":
        bias = 0xFFF + ((bits >> 13) & 1)
    else:
        bias = torch.full_like(bits, 0x1000)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def truncate_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 by dropping the 13 low mantissa bits."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str, tie: str) -> torch.Tensor:
    """a @ b of float32 operands, float32 accumulation, operands as the
    tensor cores take them: ``"tf32"`` one pass, ``"3xtf32"`` split."""
    if mode == "tf32":
        return tf32(a, tie) @ tf32(b, tie)
    a_hi, b_hi = tf32(a, tie), tf32(b, tie)
    a_lo, b_lo = truncate_tf32(a - a_hi), truncate_tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def errors(got: torch.Tensor, want: torch.Tensor) -> float:
    """The larger of the relative L2 error and max|error| / max|want|."""
    diff = got.double() - want
    return max((diff.norm() / want.norm()).item(), (diff.abs().max() / want.abs().max()).item())


def inputs(seed: int) -> dict:
    """x, g, weight at torch's init scale, scale > 0, shift > 0; float32."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {k: torch.from_numpy(v) for k, v in {
        "x": rng.randn(B, C, S, S).astype(f32),
        "g": rng.randn(B, C, S, S).astype(f32),
        "w": (rng.randn(C, C, 3, 3) / np.sqrt(9 * C)).astype(f32),
        "scale": (0.5 + rng.rand(C)).astype(f32),
        "shift": (0.05 + 0.3 * rng.rand(C)).astype(f32),
    }.items()}


def wgrad(t: dict, prologue: bool, mode: str, tie: str):
    """K5's GEMM, M = Cout, N = 9·Cin, K = B·H·W → (dW, db); db is a plain
    float32 sum, as in the kernel."""
    a = conv_bwd.prologue_activation(t["x"], t["scale"], t["shift"], prologue)
    cols = F.unfold(a, 3, padding=1).permute(1, 0, 2).reshape(C * 9, -1)  # (ci, dh, dw) × px
    gm = t["g"].permute(1, 0, 2, 3).reshape(C, -1)
    return matmul(gm, cols.T, mode, tie).reshape(C, C, 3, 3), t["g"].sum((0, 2, 3))


def dgrad(t: dict, prologue: bool, mode: str, tie: str):
    """K6's GEMM, M = B·H·W, N = Cin, K = 9·Cout, then its epilogue in
    float32 as the plain version's → (dx, red)."""
    cols = F.unfold(t["g"], 3, padding=1).permute(0, 2, 1).reshape(B * S * S, -1)
    wf = t["w"].flip(2, 3).reshape(C, C, 9).permute(0, 2, 1).reshape(C * 9, C)  # (co, tap) × ci
    da = matmul(cols, wf, mode, tie).reshape(B, S, S, C).permute(0, 3, 1, 2)
    if not prologue:
        return da, None
    mask = (t["x"] * t["scale"][:, None, None] + t["shift"][:, None, None] > 0).to(da.dtype)
    dam = da * mask
    red = torch.stack([(dam * t["x"]).sum((0, 2, 3)), dam.sum((0, 2, 3))])
    return dam * t["scale"][:, None, None], red


def fwd_inputs(seed: int) -> dict:
    """x, weight, bias of K3/K4's deep case, scale > 0, shift > 0; float32."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {k: torch.from_numpy(v) for k, v in {
        "x": rng.randn(FB, FCIN, FS, FS).astype(f32),
        "w": (rng.randn(FCOUT, FCIN, 3, 3) / np.sqrt(9 * FCIN)).astype(f32),
        "bias": (0.1 * rng.randn(FCOUT)).astype(f32),
        "scale": (0.5 + rng.rand(FCIN)).astype(f32),
        "shift": (0.05 + 0.3 * rng.rand(FCIN)).astype(f32),
    }.items()}


def forward(t: dict, prologue: bool, mode: str, tie: str):
    """K3's and K4's GEMM as the kernels order it, M = B·H·W, N = Cout, K =
    9·Cin in chunks of 8 input channels x 9 taps: each chunk's products go
    through a fresh accumulator, added to the sums in chunk order; then the
    bias and the stats over the stored y, as the plain version's → (y,
    stats)."""
    a = conv_bwd.prologue_activation(t["x"], t["scale"], t["shift"], prologue)
    b, cin, h, w = a.shape
    cout = t["w"].shape[0]
    cols = F.unfold(a, 3, padding=1).permute(0, 2, 1).reshape(b * h * w, cin * 9)  # (ci, tap)
    wm = t["w"].reshape(cout, cin * 9).T
    acc = torch.zeros((b * h * w, cout), dtype=a.dtype)
    for k0 in range(0, cin * 9, CHUNK * 9):
        acc = acc + matmul(cols[:, k0:k0 + CHUNK * 9], wm[k0:k0 + CHUNK * 9], mode, tie)
    y = (acc + t["bias"]).reshape(b, h, w, cout).permute(0, 3, 1, 2)
    return y, torch.stack([y.sum((2, 3)), (y * y).sum((2, 3))], 1)


def f64(t: dict) -> dict:
    return {k: v.double() for k, v in t.items()}


@pytest.mark.parametrize("tie", TIES)
def test_tf32_rounding_keeps_ten_mantissa_bits(tie):
    v = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32) * 1e3)
    r = tf32(v, tie)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(tf32(r, tie), r)
    assert float(((r - v).abs() / v.abs()).max()) <= 2.0 ** -11
    lo = truncate_tf32(v - r)
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((r + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21
    # 1 + 2^-11 lies halfway between two TF32 values: the tie rules part
    half = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)], dtype=torch.float32)
    want = {"even": [1.0, -(1.0 + 4 * 2.0 ** -11)],
            "away": [1.0 + 2.0 ** -10, -(1.0 + 4 * 2.0 ** -11)]}[tie]
    assert tf32(half, tie).tolist() == want


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("prologue", [True, False])
def test_k5_gemm_in_3xtf32_holds_the_bars_and_one_pass_does_not(prologue, tie):
    t = inputs(11)
    dw_ref, db_ref = conv_bwd.wgrad3x3_plain(f64(t)["x"], f64(t)["g"], f64(t)["scale"],
                                             f64(t)["shift"], prologue)
    dw3, db3 = wgrad(t, prologue, "3xtf32", tie)
    dw1, _ = wgrad(t, prologue, "tf32", tie)
    assert errors(dw3, dw_ref) <= SUM_TOL / 10
    assert errors(db3, db_ref) <= SUM_TOL / 10
    assert errors(dw1, dw_ref) > SUM_TOL


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("prologue", [True, False])
def test_k6_gemm_in_3xtf32_holds_the_bars_and_one_pass_does_not(prologue, tie):
    t = inputs(12)
    dx_ref, red_ref = conv_bwd.dgrad3x3_plain(f64(t)["g"], f64(t)["x"], f64(t)["w"],
                                              f64(t)["scale"], f64(t)["shift"], prologue)
    dx3, red3 = dgrad(t, prologue, "3xtf32", tie)
    dx1, _ = dgrad(t, prologue, "tf32", tie)
    assert errors(dx3, dx_ref) <= CONV_TOL / 10
    if prologue:
        assert errors(red3, red_ref) <= SUM_TOL / 10
    assert errors(dx1, dx_ref) > CONV_TOL


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("prologue", [True, False])
def test_k3_k4_gemm_in_3xtf32_holds_the_bars_and_one_pass_does_not(prologue, tie):
    """K = 9 * 512 in 64 chunks: 3xTF32 holds y to CONV_TOL and K4's stats
    to SUM_TOL; one TF32 pass misses CONV_TOL on y. K3 is K4's instance
    with neither the prologue nor the stats, so the case without the
    prologue covers its y."""
    t = fwd_inputs(14)
    d = f64(t)
    y_ref, st_ref = conv.conv3x3_bn_act_plain(d["x"], d["w"], d["bias"], d["scale"],
                                              d["shift"], prologue, True)
    y3, st3 = forward(t, prologue, "3xtf32", tie)
    y1, _ = forward(t, prologue, "tf32", tie)
    assert errors(y3, y_ref) <= CONV_TOL
    assert errors(st3, st_ref) <= SUM_TOL
    assert errors(y1, y_ref) > CONV_TOL


@pytest.mark.parametrize("prologue", [True, False])
def test_the_emulated_forward_gemm_is_the_plain_version(prologue):
    """In float64 with exact products, the chunked forward GEMM above is
    ``conv3x3_plain`` (K3) and ``conv3x3_bn_act_plain`` (K4, y and stats),
    so the errors above are the rounding's alone."""
    t = f64(fwd_inputs(15))

    def exact(a, b, mode, tie):
        return a @ b

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(globals(), "matmul", exact)
        y, st = forward(t, prologue, "exact", "even")
    want_y, want_st = conv.conv3x3_bn_act_plain(t["x"], t["w"], t["bias"], t["scale"],
                                                t["shift"], prologue, True)
    assert errors(y, want_y) < 1e-12
    assert errors(st, want_st) < 1e-12
    if not prologue:
        assert errors(y, conv.conv3x3_plain(t["x"], t["w"], t["bias"])) < 1e-12


def test_the_emulated_gemms_are_the_plain_versions():
    """In float64 (no rounding) the im2col GEMMs above are the plain
    versions, so the errors above are the rounding's alone."""
    t = f64(inputs(13))

    def exact(a, b, mode, tie):
        return a @ b

    for prologue in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(globals(), "matmul", exact)
            got_w = wgrad(t, prologue, "exact", "even")
            got_d = dgrad(t, prologue, "exact", "even")
        want_w = conv_bwd.wgrad3x3_plain(t["x"], t["g"], t["scale"], t["shift"], prologue)
        want_d = conv_bwd.dgrad3x3_plain(t["g"], t["x"], t["w"], t["scale"], t["shift"], prologue)
        for got, want in [*zip(got_w, want_w), (got_d[0], want_d[0])]:
            assert errors(got, want) < 1e-12
        if prologue:
            assert errors(got_d[1], want_d[1]) < 1e-12


@pytest.mark.parametrize("shape, by", [((32, 512, 40, 40, 512), "operations"),
                                       ((32, 64, 320, 320, 64), "bytes")])
def test_conv_bound_is_the_winograd_count_at_the_3xtf32_rate(shape, by):
    """The K3-K6 bound: one multiply-add per (output, channel pair), the
    Winograd limit, at 495/3 TFLOP/s (f32-accurate products on the tensor
    cores in 3xTF32), or the bytes at the memory rate where they take
    longer."""
    b, cin, h, w, cout = shape
    nbytes = 4 * b * h * w * (cin + cout)
    ms, got_by, direct = conv_bound(shape, nbytes)
    assert direct == 18.0 * b * h * w * cin * cout
    want = max(1e3 * direct / 9 / (495e12 / 3), 1e3 * nbytes / PEAK_BYTES_PER_S)
    assert (ms, got_by) == (pytest.approx(want, rel=1e-12), by)
