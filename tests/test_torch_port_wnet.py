"""Port parity: the WNet trunk and ``UpNoSkip`` against the JAX package.

The port's WNet + quantile head (torch's default init from a seeded
generator, BatchNorm running statistics randomised) is carried into the
JAX package's variables by its ``interop/torch_import.port_state_dict`` and
back into the port by ``load_jax_variables`` (a strict load), under each
``conv_backend``:

- the eval forward at (2, 24, 24, 2) under ``xla`` against the JAX WNet:
  rtol 1e-4, atol 1e-5, the tolerance of ``test_forward_matches_jax``;
  under ``pallas_fused`` (K4 with the folded BatchNorm, here through its
  plain version) within 1e-4 relative L2, the bar ``test_torch_port_fused.py``
  holds the UNet to. The reference is the JAX WNet under ``xla``: the JAX
  package's own tests hold its fused path to its xla path, and its Pallas
  kernels in interpret mode over WNet's 14 DoubleConvs would take minutes;
- one train step in f64 at (2, 16, 16, 2) under ``xla`` and under
  ``pallas_fused`` (K5/K6 backward through their plain versions) against
  the JAX f64 step under ``xla`` (the fused path does not run in f64 in the
  JAX package): the loss to 1e-12, every gradient to 1e-6 relative L2 (a
  conv bias that a BatchNorm follows, whose exact gradient is 0, to 1e-9 of
  its conv's weight gradient), the running statistics to 1e-9.

``UpNoSkip`` at scale factors 2 (K1's plain version) and 3 (the per-axis
lerps): the eval forward against the JAX block on the same weights (the
port's, carried over and back), rtol 1e-4, atol 1e-5.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from im2im_uq_tpu.interop.torch_import import _double_conv as jax_double_conv
from im2im_uq_tpu.interop.torch_import import port_state_dict
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.models.unet import UpNoSkip as JUpNoSkip
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.interop.from_jax import _double_conv, load_jax_variables, state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.models.unet import DoubleConv, UpNoSkip, WNet
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(DEFAULTS, model="WNet", uncertainty_type="quantiles", num_inputs=2,
           resize_backend="xla", dataset="synthetic", batch_size=2, lr=1e-3)
RTOL, ATOL = 1e-4, 1e-5


def _randomise_stats(model: nn.Module, rng: np.random.RandomState) -> None:
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, m.num_features)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, m.num_features)))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _port(conv_backend: str, variables: dict) -> tasm.UQState:
    cfg = dict(CFG, conv_backend=conv_backend)
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    load_jax_variables(tstate.model, variables, "WNet", "quantiles")
    return tstate


def _port_step64(tstate: tasm.UQState, batch) -> tuple:
    model = tstate.model.double()
    opt = torch.optim.Adam(model.parameters(), lr=CFG["lr"])
    step = ttrain.make_train_step(model, theads.head_loss_pe_fn("quantiles"), CFG, opt)
    loss = float(step(*(t.double() for t in ttrain.put_batch(*batch, torch.device("cpu")))))
    return (loss, {n: p.grad.double() for n, p in model.named_parameters()},
            {n: b.double() for n, b in model.named_buffers() if "running" in n})


@pytest.fixture(scope="module")
def wnet():
    """The JAX WNet's eval forward and f64 train step, and the port's under
    ``xla`` and ``pallas_fused``, from one set of weights."""
    seed = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                                generator=torch.Generator().manual_seed(0), device="cpu")
    _randomise_stats(seed.model, np.random.RandomState(1))
    params, stats = port_state_dict(seed.model.state_dict(), "WNet", "quantiles")
    variables = {"params": params, "batch_stats": stats}
    model = jasm.UQModel(trunk=jasm.build_trunk(CFG), head=jheads.build_head("quantiles", 1, CFG))
    jstate = jasm.UQState(model=model, variables=jax.tree_util.tree_map(jnp.asarray, variables),
                          params=CFG)
    x = np.random.RandomState(2).randn(2, 24, 24, 2).astype(np.float32)
    rng = np.random.RandomState(3)
    batch = (rng.randn(2, 16, 16, 2).astype(np.float32), rng.rand(2, 16, 16, 1).astype(np.float32),
             np.ones((2,), np.float32))
    out = {"jax_eval": np.asarray(jstate.forward(jnp.asarray(x)))}
    with jax.enable_x64(True):
        tx = optax.adam(CFG["lr"])
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        step = jax.jit(jtrain._train_step_body(model, jheads.head_loss_pe_fn("quantiles"), CFG, tx))
        state = jtrain.TrainState(params=v64["params"], batch_stats=v64["batch_stats"],
                                  opt_state=tx.init(v64["params"]), step=jnp.zeros((), jnp.int32))
        state, loss, grads = step(state, *(jnp.asarray(a, jnp.float64) for a in batch))
        exported = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, {"params": grads,
                                                "batch_stats": state.batch_stats}),
            "WNet", "quantiles")
    out["jax64"] = (float(loss), {n: t.double() for n, t in exported.items()})
    for backend in ("xla", "pallas_fused"):
        out[f"{backend}_eval"] = np.moveaxis(
            _port(backend, variables).forward(_nchw(x)).numpy(), 2, -1)
        out[f"{backend}64"] = _port_step64(_port(backend, variables), batch)
    return out


def test_eval_forward_matches_jax(wnet):
    assert wnet["xla_eval"].shape == wnet["jax_eval"].shape == (2, 3, 24, 24, 1)
    np.testing.assert_allclose(wnet["xla_eval"], wnet["jax_eval"], rtol=RTOL, atol=ATOL)
    assert _rel_l2(wnet["pallas_fused_eval"], wnet["jax_eval"]) < 1e-4


@pytest.mark.parametrize("conv_backend", ["xla", "pallas_fused"])
def test_train_step_in_f64_matches_jax(wnet, conv_backend):
    loss, got, stats = wnet[f"{conv_backend}64"]
    want_loss, want = wnet["jax64"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-12)
    # 14 DoubleConvs of 8 tensors, the 1x1 out-conv and the head's 3 convs
    assert len(got) == 14 * 8 + 2 + 6 and len(stats) == 14 * 4
    for n, g in got.items():
        if re.search(r"double_conv\.[03]\.bias$", n):  # a BatchNorm follows
            assert (g - want[n]).norm() <= 1e-9 * want[n[:-4] + "weight"].norm(), n
        else:
            assert (g - want[n]).norm() <= 1e-6 * want[n].norm(), n
    for n, s in stats.items():
        assert (s - want[n]).norm() <= 1e-9 * want[n].norm(), n


def test_fused_backend_reaches_every_double_conv():
    trunk = tasm.build_trunk(dict(CFG, conv_backend="pallas_fused"))
    assert isinstance(trunk, WNet)
    blocks = [m for m in trunk.modules() if isinstance(m, DoubleConv)]
    assert len(blocks) == 14 and all(b.conv_backend == "pallas_fused" for b in blocks)
    stems = [trunk.p1inc, trunk.p2inc]
    assert all(b.double_conv[0].in_channels == 1 and b.double_conv[0].out_channels == 32
               for b in stems)


@pytest.mark.parametrize("scale", [2, 3])
def test_up_no_skip_matches_jax(scale):
    torch.manual_seed(5)
    seed = UpNoSkip(16, 8, scale_factor=scale)
    _randomise_stats(seed, np.random.RandomState(5))
    params, stats = jax_double_conv(seed.state_dict(), "conv.double_conv.")
    x = np.random.RandomState(4).randn(2, 5, 7, 16).astype(np.float32)
    want = np.asarray(jax.jit(JUpNoSkip(8, scale_factor=scale).apply)(
        {"params": {"conv": params}, "batch_stats": {"conv": stats}}, jnp.asarray(x)))
    block = UpNoSkip(16, 8, scale_factor=scale)
    sd: dict = {}
    _double_conv(sd, "conv.double_conv.", params, stats)
    block.load_state_dict(sd, strict=True)
    got = block.eval()(_nchw(x)).detach().numpy()
    assert got.shape == (2, 8, 5 * scale, 7 * scale)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=RTOL, atol=ATOL)


def test_chip_smoke_wnet_conv_sites_are_the_models_launches(monkeypatch):
    """One train step of the port's WNet under ``pallas_fused`` at 16² (a
    twentieth of 320²) and batch 2 calls the K3-K6 wrappers at the channel
    counts, prologues and sides (a twentieth) of ``chip_smoke.conv_sites`` over
    ``WNET_DOUBLE_CONVS``, as often: the WNet shapes the script holds
    against the plain versions."""
    import collections

    import chip_smoke
    from im2im_uq_tpu_torch.ops import conv as tconv
    from im2im_uq_tpu_torch.ops import conv_bwd as tbwd

    calls: collections.Counter = collections.Counter()

    def record(module, name, shape_of):
        fn = getattr(module, name)

        def wrapper(*args):
            calls[name, shape_of(*args)] += 1
            return fn(*args)

        monkeypatch.setattr(module, name, wrapper)

    record(tconv, "conv3x3_fwd", lambda x, w, b: ((*x.shape, w.shape[0]), False))
    record(tconv, "conv3x3_bn_act_fwd",
           lambda x, w, b, sc, sh, p, st: ((*x.shape, w.shape[0]), p))
    record(tbwd, "wgrad3x3", lambda x, g, sc, sh, p: ((*x.shape, g.shape[1]), p))
    record(tbwd, "dgrad3x3", lambda g, x, w, sc, sh, p: ((*x.shape, g.shape[1]), p))
    cfg = dict(CFG, conv_backend="pallas_fused")
    model = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu").model.train()
    model(torch.randn(2, 2, 16, 16)).square().mean().backward()

    names = {"conv3x3": "conv3x3_fwd", "conv3x3_bn_act": "conv3x3_bn_act_fwd",
             "wgrad3x3": "wgrad3x3", "dgrad3x3": "dgrad3x3"}
    want: collections.Counter = collections.Counter()
    sites = chip_smoke.conv_sites("pallas_fused", chip_smoke.WNET_DOUBLE_CONVS)
    for kernel, launches in sites.items():
        for (_, cin, h, w, cout), prologue in launches:
            want[names[kernel], ((2, cin, h // 20, w // 20, cout), prologue)] += 1
    assert calls == want
    # K4: 2 per encoder DoubleConv (10), 1 per decoder one (4); K3: 2 per
    # decoder one; K5 as K4; K6 as K4 but the two stems
    assert sum(want.values()) == 24 + 8 + 24 + 22
