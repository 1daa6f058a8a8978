"""K5 and K6: the backward of the fused 3×3 conv (``ops/conv.conv3x3_bn_act``).

Counterpart of ``im2im_uq_tpu/ops/pallas_conv_bwd.py``:

- :func:`wgrad3x3` (K5, ``wgrad3x3_pallas_raw``): dW and db of a 3×3
  same-padding conv over ``relu(x·scale + shift)`` (with the prologue) or
  ``x``, the activation recomputed from the raw input inside the kernel;
- :func:`dgrad3x3` (K6, ``dgrad3x3_pallas_raw``): dx through the flipped
  kernel, times the ReLU mask ``x·scale + shift > 0`` and ``scale`` with the
  prologue, and the reductions (Σ dam·x, Σ dam) that are the gradients of
  ``scale`` and ``shift``.

Layout NCHW; weights and dW in ``nn.Conv2d``'s (Cout, Cin, 3, 3). On a CUDA
tensor each wrapper launches its kernel (``csrc/wgrad3x3.cu``,
``csrc/dgrad3x3.cu``); on a CPU tensor it runs its plain version; any other
device raises. x, g and the weight are float32 or bfloat16 (the TPU kernels'
dtypes, ``pallas_conv_bwd.py:51-63``); scale, shift, dW, db and the
reductions float32; dx in x's dtype. In bf16 the products are exact bf16 ×
bf16 products summed in float32: K5's activation is rounded to bf16 before
them (``pallas_conv_bwd.py:145-155``), K6's dx once at the end
(``:296-303``). A bf16 instance counts its launches apart, on
``wgrad3x3.bf16`` and ``dgrad3x3.bf16``. The JAX package takes padded
inputs and pads W to 8 for Mosaic; the port takes the unpadded tensors.
"""

from __future__ import annotations

import types
from typing import Optional

import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch import _build

__all__ = ["dgrad3x3", "dgrad3x3_plain", "wgrad3x3", "wgrad3x3_plain"]

# the dtype codes of the C entry points
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 if it is narrower (bf16 → f32, exact); f32 and f64
    as they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def prologue_activation(x, scale, shift, prologue: bool) -> torch.Tensor:
    if not prologue:
        return x
    return torch.relu(x * _per_channel(scale) + _per_channel(shift))


def wgrad3x3_plain(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: per tap, Σ over (b, y, x) of g · the shifted
    activation, as nine matrix products → (dW (Cout, Cin, 3, 3), db (Cout,)).

    A bf16 input is computed in float32 from its widened operands: the
    activation relu(f32(x)·scale + shift), rounded to bf16, 0 in the frame;
    dW the f32 sum of the exact products, db = Σ f32(g), both float32."""
    h, w = x.shape[-2:]
    a = widened(prologue_activation(widened(x), scale, shift, prologue).to(x.dtype))
    g = widened(g)
    ap = F.pad(a, (1, 1, 1, 1))
    taps = [torch.einsum("bohw,bchw->oc", g, ap[:, :, dh : dh + h, dw : dw + w])
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps, -1).unflatten(-1, (3, 3)), g.sum((0, 2, 3))


def dgrad3x3_plain(
    g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version → (dx (B, Cin, H, W) in x's dtype, red (2, Cin)).

    da[b, c, y, x] = Σ g[b, co, y+1−dh, x+1−dw]·W[co, c, dh, dw] as nine
    matrix products over the padded cotangent; with the prologue dam = da
    where x·scale + shift > 0 (else 0), dx = dam·scale and red = (Σ dam·x,
    Σ dam) per channel; without it dx = da and red = 0. A bf16 input is
    computed in float32 from its widened operands (da, the mask, dam and red
    in f32) and dx is rounded to bf16 once.
    """
    h, w = g.shape[-2:]
    gp = F.pad(widened(g), (1, 1, 1, 1))
    weight = widened(weight)
    da = None
    for dh in range(3):
        for dw in range(3):
            t = torch.einsum("oc,bohw->bchw", weight[:, :, dh, dw],
                             gp[:, :, 2 - dh : 2 - dh + h, 2 - dw : 2 - dw + w])
            da = t if da is None else da + t
    if not prologue:
        return da.to(x.dtype), da.new_zeros((2, x.shape[1]))
    xw = widened(x)
    mask = (xw * _per_channel(scale) + _per_channel(shift) > 0).to(da.dtype)
    dam = da * mask
    red = torch.stack([(dam * xw).sum((0, 2, 3)), dam.sum((0, 2, 3))])
    return (dam * _per_channel(scale)).to(x.dtype), red


def check_tensors(kernel: str, device: torch.device, dtype: torch.dtype = torch.float32,
                  **tensors) -> None:
    """Raise unless every tensor given is of ``dtype``, contiguous and on
    ``device``."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{kernel} kernel takes {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes contiguous tensors, not {name}")
        if t.device != device:
            raise ValueError(f"{kernel} kernel takes tensors on one device, {name} is on {t.device}")


def check_kernel_dtype(kernel: str, t: torch.Tensor) -> None:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, got {t.dtype}")


def check_prologue(kernel: str, scale, shift, cin: int) -> None:
    if scale is None or shift is None or scale.shape != (cin,) or shift.shape != (cin,):
        raise ValueError(f"{kernel} with the prologue takes scale and shift of shape ({cin},)")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _packed(lib, entry: str, x: torch.Tensor, *sizes) -> Optional[torch.Tensor]:
    """The packed-operand scratch of a bf16 launch (None for float32)."""
    if x.dtype != torch.bfloat16:
        return None
    return torch.empty((getattr(lib, entry)(*sizes),), dtype=torch.int32, device=x.device)


def _launch_wgrad(x, g, scale, shift, prologue: bool):
    check_kernel_dtype("wgrad3x3", x)
    check_tensors("wgrad3x3", x.device, x.dtype, x=x, g=g)
    check_tensors("wgrad3x3", x.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    if x.ndim != 4 or g.ndim != 4 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"wgrad3x3: input {tuple(x.shape)} and cotangent {tuple(g.shape)} "
                         "are not one NCHW conv's")
    b, cin, h, w = x.shape
    cout = g.shape[1]
    if prologue:
        check_prologue("wgrad3x3", scale, shift, cin)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty((cout,), dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_(), db.zero_()
    lib = _build.library()
    scratch = torch.empty((lib.im2im_wgrad3x3_scratch(b, cin, cout, h, w),),
                          dtype=torch.float32, device=x.device)
    packed = _packed(lib, "im2im_wgrad3x3_packed_words", x, b, cin, cout, h, w)
    err = lib.im2im_wgrad3x3(
        x.data_ptr(), g.data_ptr(), scale.data_ptr() if prologue else None,
        shift.data_ptr() if prologue else None, scratch.data_ptr(),
        packed.data_ptr() if packed is not None else None, dw.data_ptr(), db.data_ptr(),
        b, cin, cout, h, w, int(prologue), KERNEL_DTYPES[x.dtype], x.device.index, stream_of(x),
    )
    (wgrad3x3.bf16 if packed is not None else wgrad3x3).launches += 1
    _build.check(err, "wgrad3x3")
    return dw, db


def _launch_dgrad(g, x, weight, scale, shift, prologue: bool):
    check_kernel_dtype("dgrad3x3", x)
    check_tensors("dgrad3x3", g.device, x.dtype, g=g, x=x, weight=weight)
    check_tensors("dgrad3x3", g.device, scale=scale if prologue else None,
                  shift=shift if prologue else None)
    if g.ndim != 4 or x.ndim != 4 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"dgrad3x3: input {tuple(x.shape)} and cotangent {tuple(g.shape)} "
                         "are not one NCHW conv's")
    b, cin, h, w = x.shape
    cout = g.shape[1]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"dgrad3x3: weight {tuple(weight.shape)} is not ({cout}, {cin}, 3, 3)")
    if prologue:
        check_prologue("dgrad3x3", scale, shift, cin)
    dx = torch.empty_like(x)
    red = torch.zeros((2, cin), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, red
    if cout == 0:
        return dx.zero_(), red
    lib = _build.library()
    scratch = (torch.empty((lib.im2im_dgrad3x3_scratch(b, cin, h, w),), dtype=torch.float32,
                           device=x.device) if prologue else None)
    packed = _packed(lib, "im2im_dgrad3x3_packed_words", x, b, cin, cout, h, w)
    err = lib.im2im_dgrad3x3(
        g.data_ptr(), weight.data_ptr(), x.data_ptr(),
        scale.data_ptr() if prologue else None, shift.data_ptr() if prologue else None,
        dx.data_ptr(), scratch.data_ptr() if prologue else None, red.data_ptr(),
        packed.data_ptr() if packed is not None else None,
        b, cin, cout, h, w, int(prologue), KERNEL_DTYPES[x.dtype], x.device.index, stream_of(x),
    )
    (dgrad3x3.bf16 if packed is not None else dgrad3x3).launches += 1
    _build.check(err, "dgrad3x3")
    return dx, red


def wgrad3x3(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dW (Cout, Cin, 3, 3) and db (Cout,), float32, of the 3×3 conv whose
    input is ``x`` (raw, before the prologue) and whose cotangent is ``g``.

    The kernel on a CUDA tensor, the plain version on a CPU tensor; any
    other device raises.
    """
    if x.device.type == "cuda":
        return _launch_wgrad(x, g, scale, shift, prologue)
    if x.device.type == "cpu":
        return wgrad3x3_plain(x, g, scale, shift, prologue)
    raise RuntimeError(f"wgrad3x3 runs on cuda or cpu tensors, not {x.device}")


def dgrad3x3(
    g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dx (B, Cin, H, W) and red = (Σ dam·x, Σ dam) (2, Cin) of the 3×3
    conv with forward ``weight`` (Cout, Cin, 3, 3) for the cotangent ``g``.

    The kernel on a CUDA tensor, the plain version on a CPU tensor; any
    other device raises.
    """
    if g.device.type == "cuda":
        return _launch_dgrad(g, x, weight, scale, shift, prologue)
    if g.device.type == "cpu":
        return dgrad3x3_plain(g, x, weight, scale, shift, prologue)
    raise RuntimeError(f"dgrad3x3 runs on cuda or cpu tensors, not {g.device}")


wgrad3x3.launches = 0  # K5 kernel launches since the last reset (f32)
dgrad3x3.launches = 0  # K6 kernel launches since the last reset (f32)
# the launches of the bf16 instances, counted apart
wgrad3x3.bf16 = types.SimpleNamespace(launches=0)
dgrad3x3.bf16 = types.SimpleNamespace(launches=0)
