"""Model assembly: trunk + uncertainty head + calibrated λ̂.

Counterpart of ``im2im_uq_tpu/models/assembly.py``. :class:`UQModel` is the
network, with the reference's submodule names ``baseModel`` and
``last_layer``; :class:`UQState` carries it with the config and λ̂ and holds
the eval-mode apply paths. Tensors inside are NCHW; the head's output is
(B, K, C, H, W).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from im2im_uq_tpu_torch.models.heads import build_head, head_loss_fn
from im2im_uq_tpu_torch.models.unet import UNet, WNet
from im2im_uq_tpu_torch.ops import sets as set_ops
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib

__all__ = [
    "UQModel", "UQState", "add_uncertainty", "build_trunk", "nchw_from_nhwc", "resolve_dtype",
    "resolve_remat",
]


def nchw_from_nhwc(batch: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """(N, H, W, C) numpy batch → (N, C, H, W) tensor on ``device``.

    ``copy()`` gives canonical strides. A C=1 transpose made contiguous with
    ``np.ascontiguousarray`` keeps a channel stride of 1, which PyTorch also
    reads as channels_last, and cuDNN would then run the network in that
    layout.
    """
    return torch.from_numpy(batch.transpose(0, 3, 1, 2).copy()).to(device)


class UQModel(nn.Module):
    """forward = last_layer(baseModel(x)) (reference add_uncertainty.py:25-27)."""

    def __init__(self, trunk: nn.Module, head: nn.Module):
        super().__init__()
        self.baseModel = trunk
        self.last_layer = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.last_layer(self.baseModel(x))


@dataclasses.dataclass
class UQState:
    """A UQModel with its config params and calibrated λ̂.

    ``lhat is None`` until calibration; ``nested_sets`` then needs an
    explicit λ. The apply paths run the model in eval mode without autograd.
    """

    model: UQModel
    params: dict
    lhat: Optional[float] = None

    @property
    def uncertainty_type(self) -> str:
        return self.params["uncertainty_type"]

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode head output (B, K, C, H, W) for an NCHW batch."""
        self.model.eval()
        with torch.inference_mode():
            return self.model(x)

    def loss_fn(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The head's scalar training loss (``heads.head_loss_fn``)."""
        return head_loss_fn(self.uncertainty_type)(pred, target, self.params)

    def interval_params(self, output: torch.Tensor) -> set_ops.IntervalParams:
        return set_ops.interval_params(output, self.uncertainty_type)

    def _resolve_lam(self, lam):
        if lam is None:
            if self.lhat is None:
                raise ValueError(
                    "You have to specify lambda unless your model is already calibrated."
                )
            lam = self.lhat
        return lam

    def nested_sets_from_output(self, output: torch.Tensor, lam=None):
        """(lower, pred, upper) of a head output at λ (default λ̂), λ a
        float32 scalar on the output's device."""
        lam = torch.tensor(self._resolve_lam(lam), dtype=torch.float32, device=output.device)
        return set_ops.nested_sets_from_output(output, lam, self.uncertainty_type)

    def nested_sets(self, x: torch.Tensor, lam=None, mesh=None):
        """(lower, pred, upper), each (B, C, H, W), at λ (default λ̂).

        Over a ``mesh`` of several ranks, ``x`` is the global batch on every
        rank: each rank runs its slice (zero rows pad B to a multiple of
        the ranks; eval-mode BatchNorm leaves the real rows as they are)
        and every rank gets the global sets, in order."""
        mesh_lib.check_mesh(mesh)
        if not mesh_lib.spans(mesh):
            with torch.inference_mode():
                return self.nested_sets_from_output(self.forward(x), lam)
        b = x.shape[0]
        pad = mesh_lib.pad_to_multiple(b, mesh.size) - b
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        with torch.inference_mode():
            sets = self.nested_sets_from_output(self.forward(mesh_lib.shard_batch(mesh, x)), lam)
            return tuple(mesh_lib.fetch(mesh, t)[:b] for t in sets)

    def set_lhat(self, lhat: float) -> "UQState":
        return dataclasses.replace(self, lhat=float(lhat))

    def replace(self, **kw) -> "UQState":
        return dataclasses.replace(self, **kw)


def resolve_remat(params: dict):
    """``remat`` ∈ {False, True, 'full', 'conv', 'bn'} → the mode, as the
    JAX package resolves it (``models/assembly.py`` ``resolve_remat``):
    False, 0 and None are off, True and 1 mean "full", anything else
    raises."""
    v = params.get("remat", False)
    if v in (False, 0, None):
        return False
    if v is True or v == 1:
        return "full"
    if v in ("full", "conv", "bn"):
        return v
    raise ValueError(
        f"unknown remat mode {v!r} (expected false, true, 'full', 'conv', "
        "or 'bn')"
    )


def resolve_dtype(params: dict, dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """Compute dtype from the config's ``compute_dtype``, as the JAX
    package's ``resolve_dtype``: None, "float32" and "f32" give float32,
    "bfloat16" and "bf16" bfloat16, anything else raises; an explicit
    ``dtype`` wins. The parameters and BatchNorm statistics stay float32
    either way."""
    if dtype is not None:
        return dtype
    name = params.get("compute_dtype")
    if name in (None, "float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r}")


def build_trunk(params: dict, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Trunk factory for the config's ``model``, "UNet" or "WNet" (ResNet18
    is not yet ported); its parameters are left on the meta device until
    :func:`add_uncertainty` places and fills them.

    ``conv_backend`` takes the JAX package's values, "auto" (= "xla"),
    "xla", "pallas" and "pallas_fused" (``models/unet.py`` says what each
    runs; ``DoubleConv`` refuses any other); the parameters and their
    state-dict keys are the same under all of them. ``pool_backend`` is
    read as the JAX package's ``pool2x2`` reads it: "pallas" takes K7 and
    every other value XLA's pool; here both are the same pool (torch's
    forward, K7 as its backward), so any value builds. ``resize_backend``
    ("auto" by default) routes the decoder's upsample as the JAX package's
    does (``ops/resize.upsample2x_align_corners``). ``bn_backend`` takes "auto"
    and "flax": the JAX package's "dot" and "barrier" are not ported, and
    with ``pallas_fused``, whose kernels fold their own BatchNorm, they are
    refused as the JAX package refuses them. The UNet's ``remat`` is
    resolved as the JAX package's ``resolve_remat`` does
    (:func:`resolve_remat`) and checkpoints its blocks (``models/unet.py``);
    WNet takes no ``remat`` and ignores the key, as the JAX package's
    ``build_trunk`` does. The compute dtype is :func:`resolve_dtype`'s.
    """
    dtype = resolve_dtype(params, dtype)
    name = params.get("model", "UNet")
    if name == "ResNet18":
        raise NotImplementedError(f"trunk {name!r} is not yet ported")
    if name not in ("UNet", "WNet"):
        raise NotImplementedError(f"unknown trunk {name!r}")
    conv_backend = params.get("conv_backend", "auto")
    if conv_backend == "auto":  # as the JAX package resolves it (assembly.py:157-168)
        conv_backend = "xla"
    bn_backend = params.get("bn_backend", "auto")
    if bn_backend not in ("auto", "flax", "dot", "barrier"):
        raise ValueError(f"unknown bn_backend {bn_backend!r}")
    if bn_backend in ("dot", "barrier"):
        if conv_backend == "pallas_fused":
            raise ValueError(
                f"bn_backend={bn_backend!r} is incompatible with conv_backend="
                "'pallas_fused' (its kernels fuse their own BN); use "
                "conv_backend xla/pallas or bn_backend flax/auto"
            )
        raise NotImplementedError(f"bn_backend {bn_backend!r} is not yet ported")
    rb = params.get("resize_backend", "auto")
    with torch.device("meta"):
        if name == "WNet":  # it reads channels 0 and 1 of its input
            return WNet(n_channels_out=1, conv_backend=conv_backend, dtype=dtype,
                        resize_backend=rb)
        return UNet(n_channels_in=int(params.get("num_inputs", 1)), n_channels_out=1,
                    conv_backend=conv_backend, dtype=dtype, remat=resolve_remat(params),
                    resize_backend=rb)


def _torch_default_init(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default Conv2d init, U(±1/√fan_in) for kernels and biases
    (the JAX package's conv_kernel_init, unet.py:118-135), drawn from
    ``generator``; BatchNorm starts at weight 1, bias 0, mean 0, var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def add_uncertainty(
    trunk: nn.Module,
    params: dict,
    *,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> UQState:
    """Wrap a trunk with the configured head and place it on ``device``
    (the card unless the caller asks for the CPU). The head computes in the
    config's compute dtype (:func:`resolve_dtype`, ``dtype`` winning).

    With a ``generator`` the weights get torch's default init drawn from it
    (on the generator's device, then moved). Without one they are left
    uninitialised, for a caller that loads a state dict next.
    """
    with torch.device("meta"):
        head = build_head(
            params["uncertainty_type"], trunk.n_channels_middle, trunk.n_channels_out, params,
            resolve_dtype(params, dtype),
        )
    model = UQModel(trunk, head)
    if generator is not None:
        model = model.to_empty(device=generator.device)
        _torch_default_init(model, generator)
        model = model.to(device)
    else:
        model = model.to_empty(device=device)
    return UQState(model=model.eval(), params=dict(params), lhat=None)
