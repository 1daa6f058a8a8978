"""K3 and K4: the 3×3 same-padding convolution and its fused BatchNorm form.

Counterpart of ``im2im_uq_tpu/ops/pallas_conv.py``:

- :func:`conv3x3` (``conv3x3`` there): conv + bias; forward K3
  (``conv3x3_pallas_raw``). Its backward is torch's conv input and weight
  gradients (cuDNN on the card), as the JAX package computes this backward
  in XLA, outside any Pallas kernel (``pallas_conv.py:542-567``).
- :func:`conv3x3_bn_act` (``conv3x3_bn_act`` there): ``conv3x3(relu(x·scale
  + shift)) + bias`` with the prologue optional, returning ``(y, stats)``
  with stats[b] = (Σ_hw y[b], Σ_hw y[b]²) per channel when ``stats``, else
  zeros. Forward K4 (``_conv3x3_fused_raw``); backward K5 and K6
  (``ops/conv_bwd.py``), differentiable in x, weight, bias, scale and shift,
  the stats outputs included.

Layout NCHW, weights in ``nn.Conv2d``'s (Cout, Cin, 3, 3). On a CUDA tensor
the forward wrappers :func:`conv3x3_fwd` and :func:`conv3x3_bn_act_fwd`
launch the kernels of ``csrc/conv3x3.cu`` (float32, and the Cin = 1 stem
in bf16) or, in bf16 beyond the stem, the activation pass
(``conv_bwd.activation_nhwc``: x NHWC, the prologue applied and rounded to
bf16) and then the forward instance of K6's kernel body
(``csrc/conv3x3_bf16.cu``, planned by ``conv_bwd.conv_plan``); on a CPU
tensor they run :func:`conv3x3_plain` and :func:`conv3x3_bn_act_plain`;
any other device raises. x, weight, bias and y are float32 or bfloat16
(the TPU kernels' dtypes), scale, shift and the stats float32. A bf16
instance counts its launches apart, on ``conv3x3.bf16`` and
``conv3x3_bn_act.bf16``. K4's backward (K5, K6) runs in both dtypes. The
JAX package's channel padding to 128 lanes, its row tiles and its XLA
fallbacks for ineligible shapes have no counterpart: the kernels take
every shape.
"""

from __future__ import annotations

import types
from typing import Optional

import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.ops import conv_bwd

__all__ = [
    "conv3x3",
    "conv3x3_bn_act",
    "conv3x3_bn_act_fwd",
    "conv3x3_bn_act_plain",
    "conv3x3_fwd",
    "conv3x3_plain",
]


def _conv3x3_taps(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The nine shifted matrix products of the TPU kernel
    (``pallas_conv.py:104-114``) over the zero-padded input, then the bias."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    y = None
    for dh in range(3):
        for dw in range(3):
            t = torch.einsum("oc,bchw->bohw", weight[:, :, dh, dw],
                             xp[:, :, dh : dh + h, dw : dw + w])
            y = t if y is None else y + t
    return y if bias is None else y + bias[:, None, None]


def conv3x3_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K3's plain version: the taps' products summed, then the bias. A bf16
    input is computed in f32 from its bf16 operands and rounded once, as
    the TPU kernel's f32 accumulator is (``pallas_conv.py:104-115``)."""
    if x.dtype != torch.bfloat16:
        return _conv3x3_taps(x, weight, bias)
    return _conv3x3_taps(x.float(), weight.float(),
                         None if bias is None else bias.float()).to(x.dtype)


def conv3x3_bn_act_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool, stats: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version. The prologue is applied before the zero padding,
    so the padded frame stays 0 whatever ``shift`` is. In bf16 the
    prologue's activation is computed in f32 and rounded to bf16 before the
    products (``pallas_conv.py:155-161``); the stats, f32, are taken over the
    rounded output."""
    if x.dtype == torch.bfloat16:
        a = conv_bwd.prologue_activation(x.float(), scale, shift, prologue).to(x.dtype)
    else:
        a = conv_bwd.prologue_activation(x, scale, shift, prologue)
    y = conv3x3_plain(a, weight, bias)
    yf = y.to(torch.promote_types(y.dtype, torch.float32))  # bf16 → f32, f64 stays
    if not stats:
        return y, yf.new_zeros((y.shape[0], 2, y.shape[1]))
    return y, torch.stack([yf.sum((2, 3)), (yf * yf).sum((2, 3))], 1)


def _check_conv(kernel: str, x, weight, bias) -> tuple[int, int, int, int, int]:
    if x.ndim != 4 or weight.ndim != 4 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"{kernel}: weight {tuple(weight.shape)} is not a 3x3 kernel over "
                         f"the channels of the NCHW input {tuple(x.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"{kernel}: bias {tuple(bias.shape)} is not ({weight.shape[0]},)")
    b, cin, h, w = x.shape
    return b, cin, weight.shape[0], h, w


def _check_dtypes(kernel: str, x, weight, bias, scale, shift, prologue: bool) -> None:
    conv_bwd.check_kernel_dtype(kernel, x)
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{kernel} kernel takes {name} in x's dtype {x.dtype}, got {t.dtype}")
    conv_bwd.check_tensors(kernel, x.device, scale=scale if prologue else None,
                           shift=shift if prologue else None)
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{kernel} kernel takes contiguous tensors on x's device, not {name}")


def _launch(wrapper, x, weight, bias, scale, shift, prologue: bool,
            st: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of K3/K4, counted on ``wrapper`` (on ``wrapper.bf16`` for a
    bf16 input); the stats go to ``st`` unless it is None. K3 is the call
    with neither the prologue nor the stats. ``im2im_conv3x3_fused`` runs
    float32 and the bf16 stem (Cin = 1); ``im2im_conv3x3_wgmma`` every other
    bf16 shape, after the activation pass."""
    name = wrapper.__name__
    _check_dtypes(name, x, weight, bias, scale, shift, prologue)
    b, cin, cout, h, w = _check_conv(name, x, weight, bias)
    if prologue:
        conv_bwd.check_prologue(name, scale, shift, cin)
    y = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib, dev, stream = _build.library(), x.device.index, conv_bwd.stream_of(x)
    bias_ptr = bias.data_ptr() if bias is not None else None
    st_ptr = st.data_ptr() if st is not None else None
    bf16 = x.dtype == torch.bfloat16
    if bf16 and cin > 1:
        xp = conv_bwd.activation_nhwc(x, scale, shift, prologue)
        plan = conv_bwd.conv_plan(b, cin, cout, h, w, conv_bwd.sm_count(dev))
        wpack = torch.empty((plan.wpack_elems,), dtype=torch.bfloat16, device=x.device)
        part = (torch.empty((plan.tiles * 2 * cout,), dtype=torch.float32, device=x.device)
                if st is not None else None)
        err = lib.im2im_conv3x3_wgmma(
            xp.data_ptr(), weight.data_ptr(), bias_ptr, y.data_ptr(), wpack.data_ptr(),
            part.data_ptr() if part is not None else None, st_ptr, b, cin, xp.shape[3], cout,
            h, w, plan.bn, plan.th, plan.tw, plan.stages, plan.blocks, dev, stream)
    else:
        scratch = (torch.empty((lib.im2im_conv3x3_scratch(b, cout, h, w),), dtype=torch.float32,
                               device=x.device) if st is not None else None)
        err = lib.im2im_conv3x3_fused(
            x.data_ptr(), weight.data_ptr(), bias_ptr,
            scale.data_ptr() if prologue else None, shift.data_ptr() if prologue else None,
            y.data_ptr(), scratch.data_ptr() if st is not None else None, st_ptr,
            b, cin, cout, h, w, int(prologue), int(st is not None),
            conv_bwd.KERNEL_DTYPES[x.dtype], dev, stream)
    (wrapper.bf16 if bf16 else wrapper).launches += 1
    _build.check(err, name)
    return y


def conv3x3_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K3's wrapper, without autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _launch(conv3x3, x, weight, bias, None, None, False, None)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    raise RuntimeError(f"conv3x3 runs on cuda or cpu tensors, not {x.device}")


def conv3x3_bn_act_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool, stats: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's wrapper, without autograd: the kernel on a CUDA tensor, the
    plain version on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        st = torch.zeros((x.shape[0], 2, weight.shape[0]), dtype=torch.float32, device=x.device)
        y = _launch(conv3x3_bn_act, x, weight, bias, scale, shift, prologue,
                    st if stats else None)
        return y, st
    if x.device.type == "cpu":
        return conv3x3_bn_act_plain(x, weight, bias, scale, shift, prologue, stats)
    raise RuntimeError(f"conv3x3_bn_act runs on cuda or cpu tensors, not {x.device}")


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv3x3_fwd(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, weight, g, padding=1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, g, padding=1)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dx, dw, db


class _Conv3x3BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, prologue: bool, stats: bool):
        y, st = conv3x3_bn_act_fwd(x, weight, bias, scale, shift, prologue, stats)
        ctx.save_for_backward(x, weight, scale, shift, y)
        ctx.prologue, ctx.stats, ctx.has_bias = prologue, stats, bias is not None
        if not stats:
            ctx.mark_non_differentiable(st)
        return y, st

    @staticmethod
    def backward(ctx, gy, gst):
        x, weight, scale, shift, y = ctx.saved_tensors
        if gy.dtype == torch.bfloat16:
            return _bwd_bf16(ctx, gy, gst, x, weight, scale, shift, y)
        g = gy
        if ctx.stats:
            # stats[b] = (Σ y, Σ y²) ⇒ dy += gs + 2·y·gq, in f32 and rounded
            # to gy's dtype (pallas_conv.py:364-375)
            g = (conv_bwd.widened(gy) + gst[:, 0, :, None, None]
                 + 2.0 * conv_bwd.widened(y) * gst[:, 1, :, None, None]).to(gy.dtype)
        g = g.contiguous()
        dx = dw = db = dscale = dshift = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # K5 gives f32 sums; rounded to the weight's dtype here
            # (pallas_conv.py:446-459), not left to autograd's cast
            dw, db = conv_bwd.wgrad3x3(x, g, scale, shift, ctx.prologue)
            dw, db = dw.to(weight.dtype), db.to(weight.dtype)
        need_ps = ctx.prologue and (ctx.needs_input_grad[3] or ctx.needs_input_grad[4])
        if ctx.needs_input_grad[0] or need_ps:  # not for the stem's input
            dx, red = conv_bwd.dgrad3x3(g, x, weight, scale, shift, ctx.prologue)
            if ctx.prologue:
                dscale, dshift = red[0], red[1]
        return dx, dw, db if ctx.has_bias else None, dscale, dshift, None, None


def _bwd_bf16(ctx, gy, gst, x, weight, scale, shift, y):
    """K4's backward in bf16: the cotangent (with the stats' terms) written
    once NHWC, then K5 and K6 reading it (``conv_bwd.cotangent_nhwc``, as
    ``pallas_conv.py:371-376, 424-427``)."""
    gp = conv_bwd.cotangent_nhwc(gy.contiguous(), y if ctx.stats else None,
                                 gst.contiguous() if ctx.stats else None)
    dx = dw = db = dscale = dshift = None
    if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
        # K5 gives f32 sums; rounded to the weight's dtype here
        # (pallas_conv.py:446-459), not left to autograd's cast
        dw, db = conv_bwd.wgrad3x3_nhwc(x, gp, weight.shape[0], scale, shift, ctx.prologue)
        dw, db = dw.to(weight.dtype), db.to(weight.dtype)
    need_ps = ctx.prologue and (ctx.needs_input_grad[3] or ctx.needs_input_grad[4])
    if ctx.needs_input_grad[0] or need_ps:  # not for the stem's input
        dx, red = conv_bwd.dgrad3x3_nhwc(gp, x, weight, scale, shift, ctx.prologue)
        if ctx.prologue:
            dscale, dshift = red[0], red[1]
    return dx, dw, db if ctx.has_bias else None, dscale, dshift, None, None


def conv3x3(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """3×3 same-padding conv + bias, K3 forward; differentiable on every
    device. ``weight`` may be a slice of a larger kernel (``Up``'s split
    conv0): it is made contiguous first."""
    return _Conv3x3.apply(x.contiguous(), weight.contiguous(), bias)


def conv3x3_bn_act(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
    prologue: bool = True, stats: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(conv3x3(relu(x·scale + shift)) + bias, stats)``, K4 forward, K5 and
    K6 backward; ``scale`` and ``shift`` may be None without the prologue."""
    return _Conv3x3BnAct.apply(x.contiguous(), weight.contiguous(), bias, scale, shift,
                               prologue, stats)


conv3x3.launches = 0  # K3 kernel launches since the last reset (f32)
conv3x3_bn_act.launches = 0  # K4 kernel launches since the last reset (f32)
# the launches of the bf16 instances, counted apart
conv3x3.bf16 = types.SimpleNamespace(launches=0)
conv3x3_bn_act.bf16 = types.SimpleNamespace(launches=0)
