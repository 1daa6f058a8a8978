"""Load a JAX model's variables into the port's UQModel.

``im2im_uq_tpu.interop.torch_export.export_state_dict`` turns the JAX
package's ``{params, batch_stats}`` into a state dict in the reference's
layout (``baseModel.*`` / ``last_layer.*``, OIHW conv weights, BatchNorm
running stats); the port's module names are exactly those keys, so the
load is strict.
"""

from __future__ import annotations

from im2im_uq_tpu.interop.torch_export import export_state_dict

from im2im_uq_tpu_torch.models.assembly import UQModel

__all__ = ["load_jax_variables"]


def load_jax_variables(
    uq_model: UQModel, variables_np: dict, model: str, uncertainty_type: str
) -> UQModel:
    """Copy JAX ``{params, batch_stats}`` (as numpy) into ``uq_model`` in place."""
    state_dict = export_state_dict(variables_np, model, uncertainty_type)
    uq_model.load_state_dict(state_dict, strict=True)
    return uq_model
