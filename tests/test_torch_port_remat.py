"""``remat`` on the port's UNet: activation checkpointing of its blocks, as
the JAX package's ``nn.remat`` with the policies "full", "conv" and "bn"
(``im2im_uq_tpu/models/unet.py:815-833``).

- Every mode computes the same function as remat off: one
  ``make_train_step`` of the UNet + quantile head at 32², batch 2, from one
  seeded init, gives the same loss, gradients and BatchNorm running
  statistics bit for bit under every mode, conv backend (``xla``,
  ``pallas``, ``pallas_fused``, the kernels' plain versions on the CPU) and
  compute dtype (f32, bf16).
- The recompute runs, and moves no running statistic: each mode's
  checkpointed regions call BatchNorm again in the backward (the count
  pins which regions a mode checkpoints: "full" every block, "conv" both
  BatchNorms of a DoubleConv, "bn" the first; under ``pallas_fused``,
  whose blocks JAX tags nowhere, "conv" the whole DoubleConv and "bn"
  nothing), while the statistics move once per BatchNorm and step.
- One f64 step of the port with remat "conv" against the JAX package's
  f64 step with remat "conv" (``xla`` convs, 16², batch 2), at the bars of
  ``test_torch_port_fused.py``'s f64 step.
- WNet takes ``remat`` and ignores it, as the JAX package's ``build_trunk``
  does (it never reads the key for WNet).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables, state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.models import unet as tunet
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(
    DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
    lane_pack=False, dataset="synthetic", batch_size=2, lr=1e-3,
)
MODES = ["full", "conv", "bn"]
BACKENDS = ["xla", "pallas", "pallas_fused"]


def _batch(side: int):
    ds = SyntheticDataset(num_examples=2, image_size=side, seed=21)
    return (np.stack([ds[i][0] for i in range(2)]), np.stack([ds[i][1] for i in range(2)]),
            np.ones((2,), np.float32))


@functools.cache
def _step(backend: str, dtype: str, remat) -> tuple:
    """One train step at 32², batch 2, from the seed-0 init → (loss,
    gradients, buffers)."""
    cfg = dict(CFG, conv_backend=backend, compute_dtype=dtype, remat=remat)
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = ttrain.make_train_step(state.model, theads.head_loss_pe_fn("quantiles"), cfg, opt)
    loss = step(*ttrain.put_batch(*_batch(32), torch.device("cpu")))
    return (loss, {n: p.grad for n, p in state.model.named_parameters()},
            dict(state.model.named_buffers()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_is_remat_offs_bit_for_bit(dtype, backend, mode):
    loss, grads, bufs = _step(backend, dtype, mode)
    want_loss, want_grads, want_bufs = _step(backend, dtype, False)
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want_grads.keys() and len(grads) == 80
    for n, g in grads.items():
        assert torch.equal(g, want_grads[n]), n
    assert bufs.keys() == want_bufs.keys() and len(bufs) == 54
    for n, b in bufs.items():
        assert torch.equal(b, want_bufs[n]), n
    assert {int(b) for n, b in bufs.items() if "num_batches" in n} == {1}


# BatchNorm calls in the recompute of one train step (18 BatchNorms)
RECOMPUTED = {("xla", "full"): 18, ("xla", "conv"): 18, ("xla", "bn"): 9,
              ("pallas", "full"): 18, ("pallas", "conv"): 18, ("pallas", "bn"): 9,
              ("pallas_fused", "full"): 18, ("pallas_fused", "conv"): 18,
              ("pallas_fused", "bn"): 0}


@pytest.mark.parametrize("backend, mode", sorted(RECOMPUTED))
def test_recompute_runs_and_moves_the_statistics_once(backend, mode, monkeypatch):
    calls = {True: 0, False: 0}
    moves = []
    fn = "fold_batchnorm" if backend == "pallas_fused" else "batch_norm"
    wrapped, move = getattr(tunet, fn), tunet._move_running_stats

    def count(*args):
        calls[tunet._recomputing] += 1
        return wrapped(*args)

    monkeypatch.setattr(tunet, fn, count)
    monkeypatch.setattr(tunet, "_move_running_stats", lambda *a: (moves.append(a[0]), move(*a)))
    cfg = dict(CFG, conv_backend=backend, remat=mode)
    model = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu").model.train()
    x = torch.from_numpy(np.ascontiguousarray(_batch(32)[0].transpose(0, 3, 1, 2)))
    out = model(x)
    assert calls == {False: 18, True: 0}
    out.square().mean().backward()
    assert calls == {False: 18, True: RECOMPUTED[backend, mode]}
    if backend == "pallas_fused":  # nn.BatchNorm2d moves its own statistics
        assert len(moves) == 18 and len(set(map(id, moves))) == 18


def test_remat_step_in_f64_matches_the_jax_packages_remat_step():
    """The JAX package's f64 train step with remat "conv" (xla convs) against
    the port's: the loss to 1e-12, every gradient to 1e-6 relative L2 (a
    conv bias that a BatchNorm follows, whose exact gradient is 0, to 1e-9 of
    its conv's weight gradient), the running statistics to 1e-9."""
    cfg = dict(CFG, conv_backend="xla", remat="conv")
    batch = _batch(16)
    jstate = jasm.add_uncertainty(jasm.build_trunk(cfg), cfg, rng=jax.random.key(0),
                                  example_input=jnp.zeros((2, 16, 16, 1)))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               jax.device_get(dict(jstate.variables)))
    with jax.enable_x64(True):
        tx = optax.adam(cfg["lr"])
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        step = jax.jit(jtrain._train_step_body(jstate.model, jheads.head_loss_pe_fn("quantiles"),
                                               cfg, tx))
        state = jtrain.TrainState(params=v64["params"], batch_stats=v64["batch_stats"],
                                  opt_state=tx.init(v64["params"]),
                                  step=jnp.zeros((), jnp.int32))
        state, want_loss, grads = step(state, *(jnp.asarray(a, jnp.float64) for a in batch))
        want = state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, jax.device_get(grads)),
             "batch_stats": jax.tree_util.tree_map(np.asarray, jax.device_get(state.batch_stats))},
            "UNet", "quantiles")
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    assert tstate.model.baseModel.remat == "conv"
    load_jax_variables(tstate.model, v, "UNet", "quantiles")
    tstate.model.double()
    opt = torch.optim.Adam(tstate.model.parameters(), lr=cfg["lr"])
    tstep = ttrain.make_train_step(tstate.model, theads.head_loss_pe_fn("quantiles"), cfg, opt)
    loss = float(tstep(*(t.double() for t in ttrain.put_batch(*batch, torch.device("cpu")))))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-12)
    for n, p in tstate.model.named_parameters():
        w = want[n].double()
        if n.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            assert (p.grad - w).norm() <= 1e-9 * want[n[:-4] + "weight"].double().norm(), n
        else:
            assert (p.grad - w).norm() <= 1e-6 * w.norm(), n
    for n, b in tstate.model.named_buffers():
        if "running" in n:
            w = want[n].double()
            assert (b - w).norm() <= 1e-9 * w.norm(), n


@pytest.mark.parametrize("remat", [False, True, "full", "conv", "bn", "bogus"])
def test_wnet_takes_remat_and_ignores_it_as_the_jax_package_does(remat):
    cfg = dict(CFG, model="WNet", remat=remat)
    jasm.build_trunk(cfg)  # the JAX package builds WNet whatever remat says
    trunk = tasm.build_trunk(cfg)
    assert isinstance(trunk, tunet.WNet) and not hasattr(trunk, "remat")
    assert all(m.remat is False for m in trunk.modules() if isinstance(m, tunet.DoubleConv))
