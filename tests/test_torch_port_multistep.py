"""Port parity: ``make_train_multistep`` on the CPU.

On the CPU the port's multistep is a plain loop of ``make_train_step``'s
step, so it equals N sequential steps bit for bit (loss, weights, BatchNorm
statistics, Adam's state). Against the JAX ``make_train_multistep`` (its
``fori_loop``) on the same init and batch, K = 3 steps at 32²:

- under SGD in float64 on both sides (``jax.enable_x64``), which pins the
  semantics: the last loss within rtol 1e-12 (measured equal), the whole
  update (every parameter's change from the init) within 1e-9 relative L2
  (measured 2e-14), and every parameter and running statistic within rtol
  1e-9, atol 1e-12 (measured 9e-16 at most). In f32 the two sides'
  per-tensor gradients differ by a few percent at ReLU and max-pool kinks
  (``tests/test_torch_port_train.py``), so f32 parameters are not compared
  per tensor there;
- under Adam in f32: the last loss within rtol 2e-2, the bar of
  ``tests/test_torch_port_train.py`` for f32 steps (measured 1.4e-3), and
  the parameters within K·2e-3, ``tests/test_multistep.py``'s bar (a
  gradient near zero can flip Adam's update, ±lr a step; measured 5.7e-3).

The CUDA graph is the card's (``chip_smoke.py``'s ``multistep`` phase); a
mesh of several ranks is refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.interop.torch_export import export_state_dict
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.training import train as jtrain

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.parallel.mesh import Mesh
from im2im_uq_tpu_torch.training import train as ttrain

CFG = {"model": "UNet", "uncertainty_type": "quantiles", "q_lo": 0.05, "q_hi": 0.95,
       "q_lo_weight": 1.0, "q_hi_weight": 1.0, "mse_weight": 1.0, "resize_backend": "xla",
       "lane_pack": False}
K = 3


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 32, 32, 1).astype(np.float32)
    y = rng.randn(4, 32, 32, 1).astype(np.float32)
    return x, y, np.array([1, 1, 1, 0], np.float32)


def _torch_batch():
    x, y, mask = _batch()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return t(x), t(y), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def jax_init():
    st = jasm.add_uncertainty(jasm.build_trunk(CFG), dict(CFG), rng=jax.random.key(0),
                              example_input=jnp.zeros((1, 32, 32, 1)))
    return st.model, jax.tree_util.tree_map(np.asarray, jax.device_get(dict(st.variables)))


def _port(variables=None, seed=0):
    if variables is None:
        return tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                                    generator=torch.Generator().manual_seed(seed), device="cpu")
    st = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(st.model, variables, "UNet", "quantiles")
    return st


def _everything(model, opt) -> dict:
    out = {k: v.clone() for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"adam.{i}.{n}": v.clone() for n, v in st.items()})
    return out


@pytest.mark.parametrize("watch", [False, True])
def test_multistep_equals_sequential_steps_bit_for_bit(watch):
    cfg = dict(CFG, watch_gradients=watch)
    batch = _torch_batch()
    a = _port()
    opt_a = torch.optim.Adam(a.model.parameters(), lr=1e-3)
    step = ttrain.make_train_step(a.model, theads.head_loss_pe_fn("quantiles"), cfg, opt_a)
    for _ in range(K):
        out = step(*batch)
    seq_loss = out[0] if watch else out
    b = _port()
    opt_b = torch.optim.Adam(b.model.parameters(), lr=1e-3)
    loop = ttrain.make_train_multistep(b.model, theads.head_loss_pe_fn("quantiles"), cfg, opt_b,
                                       num_steps=K)
    loss = loop(*batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert torch.equal(loss, seq_loss)
    want, got = _everything(a.model, opt_a), _everything(b.model, opt_b)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(opt_b.state_dict()["state"][0]["step"]) == K


def _run_both(jax_init, jax_tx, torch_opt, f64: bool = False):
    """K steps of the JAX multistep and of the port's from the same init →
    (JAX loss, JAX step count, JAX state dict, port loss, port state dict),
    in float64 on both sides when ``f64``."""
    model, variables = jax_init
    jdtype, tdtype = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    with jax.enable_x64(f64):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), variables)
        ts = jtrain.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                               opt_state=jax_tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
        loop = jtrain.make_train_multistep(model, jheads.head_loss_pe_fn("quantiles"), CFG,
                                           jax_tx, num_steps=K)
        ts, jloss = loop(ts, *(jnp.asarray(a, jdtype) for a in _batch()))
        tree = jax.tree_util.tree_map(np.asarray, {"params": ts.params,
                                                   "batch_stats": ts.batch_stats})
        jloss, jsteps = float(jloss), int(ts.step)
    want = export_state_dict(tree, "UNet", "quantiles")
    st = _port(variables)
    st.model.to(tdtype)
    opt = torch_opt(st.model.parameters())
    tloop = ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt,
                                        num_steps=K)
    tloss = tloop(*(t.to(tdtype) for t in _torch_batch()))
    return jloss, jsteps, want, float(tloss), st.model.state_dict()


def test_multistep_matches_jax_under_sgd_in_f64(jax_init):
    jloss, jsteps, want, tloss, got = _run_both(
        jax_init, optax.sgd(1e-2), lambda p: torch.optim.SGD(p, lr=1e-2), f64=True)
    assert jsteps == K
    assert tloss == pytest.approx(jloss, rel=1e-12)
    init = _port(jax_init[1]).model.state_dict()
    params = [k for k in want if "running" not in k and not k.endswith("num_batches_tracked")]
    delta_got = torch.cat([(got[k] - init[k].double()).flatten() for k in params])
    delta_want = torch.cat([(want[k].double() - init[k].double()).flatten() for k in params])
    assert ((delta_got - delta_want).norm() / delta_want.norm()).item() < 1e-9
    for k in want:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-9, atol=1e-12,
                                       err_msg=k)


def test_multistep_matches_jax_adam_semantics(jax_init):
    jloss, jsteps, want, tloss, got = _run_both(
        jax_init, optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3))
    assert jsteps == K
    assert tloss == pytest.approx(jloss, rel=2e-2)
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=K * 2e-3, err_msg=k)


def test_multistep_refuses_a_mesh_of_several_ranks_and_zero_steps():
    st = _port()
    opt = torch.optim.Adam(st.model.parameters(), lr=1e-3)
    mesh = Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt, 2,
                                    mesh=mesh)
    with pytest.raises(ValueError, match="num_steps"):
        ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt, 0)
    one = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    loop = ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt,
                                       1, mesh=one)
    assert torch.isfinite(loop(*_torch_batch()))


def test_cached_tables_made_under_inference_mode_serve_autograd():
    """The plain versions' constant tables are kept on the device per shape
    (a CUDA graph's capture may copy nothing from the host); one first made
    by an eval forward under ``torch.inference_mode`` still serves a train
    step's autograd, a second call takes the same tensors, and a table made
    while ``torch.export`` traces is not kept (it is a fake tensor there)."""
    from im2im_uq_tpu_torch.ops import constants, losses, resize, upsample

    constants.clear()
    x = torch.randn(2, 3, 5, 7)
    with torch.inference_mode():
        upsample.upsample2x_plain(x)
        resize.resize_bilinear_align_corners(x, (9, 4))
        losses.bucketize_targets(torch.rand(4), 6)
    xg = x.clone().requires_grad_(True)
    y = upsample.upsample2x_plain(xg).sum() + resize.resize_bilinear_align_corners(xg, (9, 4)).sum()
    y.backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    assert losses.bucketize_targets(torch.rand(4), 6).dtype == torch.int64
    first = upsample._device_tables(upsample.phase_weights, 5, x.device, x.dtype)
    assert upsample._device_tables(upsample.phase_weights, 5, x.device, x.dtype) is first
    assert not any(t.is_inference() for t in first)
    ep = torch.export.export(_Upsample(), (torch.randn(1, 2, 6, 3),))
    assert not any(type(t) is not torch.Tensor for v in constants._TABLES.values() for t in v)
    got = ep.module()(x[:1, :2, :5, :3].repeat(1, 1, 1, 1).new_ones(1, 2, 6, 3))
    want = upsample.upsample2x_plain(torch.ones(1, 2, 6, 3))
    assert torch.equal(got, want)


class _Upsample(torch.nn.Module):
    def forward(self, x):
        from im2im_uq_tpu_torch.ops import upsample

        return upsample.upsample2x_plain(x)
