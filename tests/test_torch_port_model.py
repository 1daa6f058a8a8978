"""Port parity: the UNet + quantile head forward against the JAX package.

The JAX model is built with ``resize_backend: "xla"``; its batch statistics
are randomised (means ~N(0, 0.1), variances ~U(0.5, 2)) so that eval-mode
BatchNorm is not the identity, and its variables are carried into the port
with ``load_jax_variables`` (a strict state-dict load). Inputs come from a
seeded RandomState.

Tolerance: rtol 1e-4, atol 1e-5 in f32. Both sides run f32 convolutions on
the CPU with different algorithms and summation orders, through 19 conv
layers; the largest difference seen at 36x44 is 6e-8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from im2im_uq_tpu.models import assembly as jasm

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
CFG = {"model": "UNet", "uncertainty_type": "quantiles", "resize_backend": "xla"}


def _randomise_stats(stats, rng: np.random.RandomState):
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def pair():
    jstate = jasm.add_uncertainty(
        jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
        example_input=jnp.zeros((2, 36, 44, 1)),
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    variables = {
        "params": variables["params"],
        "batch_stats": _randomise_stats(variables["batch_stats"], np.random.RandomState(1)),
    }
    jstate = jstate.replace(variables=jax.tree_util.tree_map(jnp.asarray, variables))
    tstate = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    return jstate, tstate


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw", [(36, 44), (32, 32)])
def test_forward_matches_jax(pair, hw):
    jstate, tstate = pair
    x = _x((2, *hw, 1), seed=2)
    want = np.asarray(jstate.forward(jnp.asarray(x)))  # (B, K, H, W, C)
    got = tstate.forward(_nchw(x))  # (B, K, C, H, W)
    assert got.shape == (2, 3, 1, *hw)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, rtol=RTOL, atol=ATOL)


def test_nested_sets_match_jax(pair):
    jstate, tstate = pair
    x = _x((2, 36, 44, 1), seed=3)
    lam = 1.3
    want = jstate.nested_sets(jnp.asarray(x), lam=lam)
    got = tstate.nested_sets(_nchw(x), lam=lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_nested_sets_need_lambda_until_calibrated(pair):
    _, tstate = pair
    with pytest.raises(ValueError, match="specify lambda"):
        tstate.nested_sets(torch.zeros(1, 1, 16, 16))
    lo, pred, hi = tstate.set_lhat(0.5).nested_sets(torch.zeros(1, 1, 16, 16))
    assert (lo < pred).all() and (pred < hi).all()


def test_generator_init_is_seeded_torch_default():
    states = [
        tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                             generator=torch.Generator().manual_seed(7), device="cpu")
        for _ in range(2)
    ]
    a, b = (s.model.state_dict() for s in states)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for m in states[0].model.modules():
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** 0.5
            assert m.weight.abs().max() <= bound and m.bias.abs().max() <= bound
            assert m.weight.abs().max() > 0.5 * bound
        if isinstance(m, nn.BatchNorm2d):
            assert (m.eps, m.momentum) == (1e-5, 0.1)
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))


@pytest.mark.parametrize("override", [{"bn_backend": "dot"}])
def test_unported_configs_raise(override):
    # ResNet18 is ported (test_torch_port_resnet.py); the JAX package's
    # "dot" BatchNorm is not
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tasm.build_trunk(dict(CFG, **override))


@pytest.mark.parametrize("remat", [False, 0, None, True, 1, "full", "conv", "bn", "bogus", 2])
def test_remat_is_resolved_as_the_jax_package_resolves_it(remat):
    cfg = dict(CFG, remat=remat)
    try:
        want = jasm.resolve_remat(cfg)
    except ValueError:
        with pytest.raises(ValueError, match="unknown remat mode"):
            tasm.resolve_remat(cfg)
        with pytest.raises(ValueError, match="unknown remat mode"):
            tasm.build_trunk(cfg)
        return
    assert tasm.resolve_remat(cfg) == want
    trunk = tasm.build_trunk(cfg)
    assert isinstance(trunk, nn.Module) and trunk.remat == want


def test_unported_head_raises():
    """Every head type is ported; an unknown one raises as the JAX package's
    ``build_head`` does."""
    cfg = dict(CFG, uncertainty_type="bogus")
    with pytest.raises(NotImplementedError, match="unknown uncertainty_type 'bogus'"):
        jasm.add_uncertainty(jasm.build_trunk(cfg), cfg)
    with pytest.raises(NotImplementedError, match="unknown uncertainty_type 'bogus'"):
        tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
