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
``csrc/dgrad3x3.cu``), float32 only; on a CPU tensor it runs its plain
version; any other device raises. The JAX package takes padded inputs and
pads W to 8 for Mosaic; the port takes the unpadded tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from im2im_uq_tpu_torch import _build

__all__ = ["dgrad3x3", "dgrad3x3_plain", "wgrad3x3", "wgrad3x3_plain"]


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def prologue_activation(x, scale, shift, prologue: bool) -> torch.Tensor:
    if not prologue:
        return x
    return torch.relu(x * _per_channel(scale) + _per_channel(shift))


def wgrad3x3_plain(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: per tap, Σ over (b, y, x) of g · the shifted
    activation, as nine matrix products → (dW (Cout, Cin, 3, 3), db (Cout,))."""
    h, w = x.shape[-2:]
    ap = F.pad(prologue_activation(x, scale, shift, prologue), (1, 1, 1, 1))
    taps = [torch.einsum("bohw,bchw->oc", g, ap[:, :, dh : dh + h, dw : dw + w])
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps, -1).unflatten(-1, (3, 3)), g.sum((0, 2, 3))


def dgrad3x3_plain(
    g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version → (dx (B, Cin, H, W), red (2, Cin)).

    da[b, c, y, x] = Σ g[b, co, y+1−dh, x+1−dw]·W[co, c, dh, dw] as nine
    matrix products over the padded cotangent; with the prologue dam = da
    where x·scale + shift > 0 (else 0), dx = dam·scale and red = (Σ dam·x,
    Σ dam) per channel; without it dx = da and red = 0.
    """
    h, w = g.shape[-2:]
    gp = F.pad(g, (1, 1, 1, 1))
    da = None
    for dh in range(3):
        for dw in range(3):
            t = torch.einsum("oc,bohw->bchw", weight[:, :, dh, dw],
                             gp[:, :, 2 - dh : 2 - dh + h, 2 - dw : 2 - dw + w])
            da = t if da is None else da + t
    if not prologue:
        return da, da.new_zeros((2, x.shape[1]))
    mask = (x * _per_channel(scale) + _per_channel(shift) > 0).to(da.dtype)
    dam = da * mask
    red = torch.stack([(dam * x).sum((0, 2, 3)), dam.sum((0, 2, 3))])
    return dam * _per_channel(scale), red


def check_tensors(kernel: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor given is float32, contiguous and on ``device``."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} kernel takes float32, got {t.dtype} for {name}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel takes contiguous tensors, not {name}")
        if t.device != device:
            raise ValueError(f"{kernel} kernel takes tensors on one device, {name} is on {t.device}")


def check_prologue(kernel: str, scale, shift, cin: int) -> None:
    if scale is None or shift is None or scale.shape != (cin,) or shift.shape != (cin,):
        raise ValueError(f"{kernel} with the prologue takes scale and shift of shape ({cin},)")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_wgrad(x, g, scale, shift, prologue: bool):
    check_tensors("wgrad3x3", x.device, x=x, g=g, scale=scale if prologue else None,
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
    err = lib.im2im_wgrad3x3(
        x.data_ptr(), g.data_ptr(), scale.data_ptr() if prologue else None,
        shift.data_ptr() if prologue else None, scratch.data_ptr(), dw.data_ptr(),
        db.data_ptr(), b, cin, cout, h, w, int(prologue), x.device.index, stream_of(x),
    )
    wgrad3x3.launches += 1
    _build.check(err, "wgrad3x3")
    return dw, db


def _launch_dgrad(g, x, weight, scale, shift, prologue: bool):
    check_tensors("dgrad3x3", g.device, g=g, x=x, weight=weight,
                  scale=scale if prologue else None, shift=shift if prologue else None)
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
    err = lib.im2im_dgrad3x3(
        g.data_ptr(), weight.data_ptr(), x.data_ptr(),
        scale.data_ptr() if prologue else None, shift.data_ptr() if prologue else None,
        dx.data_ptr(), scratch.data_ptr() if prologue else None, red.data_ptr(),
        b, cin, cout, h, w, int(prologue), x.device.index, stream_of(x),
    )
    dgrad3x3.launches += 1
    _build.check(err, "dgrad3x3")
    return dx, red


def wgrad3x3(
    x: torch.Tensor, g: torch.Tensor, scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor], prologue: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dW (Cout, Cin, 3, 3) and db (Cout,) of the 3×3 conv whose input is
    ``x`` (raw, before the prologue) and whose cotangent is ``g``.

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


wgrad3x3.launches = 0  # K5 kernel launches since the last reset
dgrad3x3.launches = 0  # K6 kernel launches since the last reset
