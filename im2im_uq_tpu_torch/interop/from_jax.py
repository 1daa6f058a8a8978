"""Load a JAX model's variables into the port's UQModel.

:func:`state_dict_from_jax` is the port's copy of the layout mapping of
``im2im_uq_tpu/interop/torch_export.py`` (``export_state_dict``) for the
UNet and WNet trunks and every head: it turns the JAX package's
``{params, batch_stats}`` (as numpy) into a state dict in the reference's
layout (``baseModel.*`` / ``last_layer.*``, OIHW conv weights, BatchNorm
running stats). The port's module names are exactly those keys, so the load
is strict. The JAX package's parameter tree is the same under every
``conv_backend``, so one mapping serves them all.

Two layouts the JAX package does not export, defined here:

- ResNet18 (``models/resnet.py``): the JAX module names as they are,
  ``baseModel.stem.weight``, ``baseModel.stem_bn.*``,
  ``baseModel.block{i}.{conv1,bn1,conv2,bn2,proj,bn_proj}.*`` and
  ``baseModel.out.{weight,bias}``; the convs without bias carry no
  ``bias`` key;
- the ConvTranspose ``Up`` of ``UNet(bilinear=False)``: ``up{i}.up.weight``
  and ``.bias``, the reference's ``nn.ConvTranspose2d`` keys. Flax's
  ``ConvTranspose`` does not flip its kernel, so its (kh, kw, in, out)
  kernel goes to torch's (in, out, kh, kw) flipped in both spatial axes
  (``tests/test_torch_port_resnet.py`` holds the two ops to each other).
"""

from __future__ import annotations

import numpy as np
import torch

from im2im_uq_tpu_torch.models.assembly import UQModel

__all__ = ["load_jax_variables", "state_dict_from_jax"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _conv(out: dict, prefix: str, tree: dict) -> None:
    """flax (kh, kw, in, out) kernel → torch Conv2d (out, in, kh, kw) weight;
    the bias where the conv has one."""
    out[prefix + "weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in tree:
        out[prefix + "bias"] = _t(tree["bias"])


def _conv_transpose(out: dict, prefix: str, tree: dict) -> None:
    """flax ConvTranspose (kh, kw, in, out) kernel → torch ConvTranspose2d
    (in, out, kh, kw) weight, flipped spatially (module docstring)."""
    kernel = np.asarray(tree["kernel"])[::-1, ::-1]
    out[prefix + "weight"] = _t(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    out[prefix + "bias"] = _t(tree["bias"])


def _bn(out: dict, prefix: str, params: dict, stats: dict) -> None:
    out[prefix + "weight"] = _t(params["scale"])
    out[prefix + "bias"] = _t(params["bias"])
    out[prefix + "running_mean"] = _t(stats["mean"])
    out[prefix + "running_var"] = _t(stats["var"])
    # the JAX package keeps no update counter; its value does not enter eval
    out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _double_conv(out: dict, prefix: str, params: dict, stats: dict) -> None:
    """JAX conv{i}/bn{i} → the reference's Sequential indices 0/1 and 3/4."""
    for i, (c, b) in enumerate(((0, 1), (3, 4))):
        _conv(out, f"{prefix}{c}.", params[f"conv{i}"])
        _bn(out, f"{prefix}{b}.", params[f"bn{i}"], stats[f"bn{i}"])


def _decoder(out: dict, params: dict, stats: dict, prefix: str) -> None:
    """The four ``Up`` blocks and the 1x1 out-conv, which UNet and WNet share."""
    for i in (1, 2, 3, 4):
        if "up" in params[f"up{i}"]:  # bilinear=False
            _conv_transpose(out, f"{prefix}up{i}.up.", params[f"up{i}"]["up"])
        _double_conv(
            out, f"{prefix}up{i}.conv.double_conv.",
            params[f"up{i}"]["conv"], stats[f"up{i}"]["conv"],
        )
    _conv(out, f"{prefix}out.conv.", params["out"])


def _unet(out: dict, params: dict, stats: dict, prefix: str = "baseModel.") -> None:
    _double_conv(out, f"{prefix}inc.double_conv.", params["inc"], stats["inc"])
    for i in (1, 2, 3, 4):
        _double_conv(
            out, f"{prefix}down{i}.maxpool_conv.1.double_conv.",
            params[f"down{i}"]["conv"], stats[f"down{i}"]["conv"],
        )
    _decoder(out, params, stats, prefix)


def _wnet(out: dict, params: dict, stats: dict, prefix: str = "baseModel.") -> None:
    for tag in ("p1", "p2"):
        _double_conv(
            out, f"{prefix}{tag}inc.double_conv.",
            params[f"{tag}inc"], stats[f"{tag}inc"],
        )
        for i in (1, 2, 3, 4):
            _double_conv(
                out, f"{prefix}{tag}down{i}.maxpool_conv.1.double_conv.",
                params[f"{tag}down{i}"]["conv"], stats[f"{tag}down{i}"]["conv"],
            )
    _decoder(out, params, stats, prefix)


def _resnet(out: dict, params: dict, stats: dict, prefix: str = "baseModel.") -> None:
    _conv(out, f"{prefix}stem.", params["stem"])
    _bn(out, f"{prefix}stem_bn.", params["stem_bn"], stats["stem_bn"])
    for i in range(8):
        block, block_stats = params[f"block{i}"], stats[f"block{i}"]
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("proj", "bn_proj")):
            if conv in block:
                _conv(out, f"{prefix}block{i}.{conv}.", block[conv])
                _bn(out, f"{prefix}block{i}.{bn}.", block[bn], block_stats[bn])
    _conv(out, f"{prefix}out.", params["out"])


def _head(out: dict, head: dict, uncertainty_type: str, prefix: str = "last_layer.") -> None:
    if uncertainty_type == "softmax":
        for name, tree in head.items():  # out{c} → output_layers.{c}
            c = int(name.removeprefix("out"))
            _conv(out, f"{prefix}output_layers.{c}.", tree)
        return
    for name, tree in head.items():  # lower/prediction/upper, mean/variance, ...
        _conv(out, f"{prefix}{name}.", tree)


def state_dict_from_jax(variables_np: dict, model: str, uncertainty_type: str) -> dict:
    """JAX ``{params, batch_stats}`` (numpy) → the port's state dict."""
    trunks = {"UNet": _unet, "WNet": _wnet, "ResNet18": _resnet}
    if model not in trunks:
        raise NotImplementedError(f"unknown trunk {model!r}")
    params, stats = variables_np["params"], variables_np.get("batch_stats", {})
    out: dict = {}
    trunks[model](out, params["trunk"], stats["trunk"])
    _head(out, params["head"], uncertainty_type)
    return out


def load_jax_variables(
    uq_model: UQModel, variables_np: dict, model: str, uncertainty_type: str
) -> UQModel:
    """Copy JAX ``{params, batch_stats}`` (as numpy) into ``uq_model`` in place."""
    uq_model.load_state_dict(state_dict_from_jax(variables_np, model, uncertainty_type),
                             strict=True)
    return uq_model
