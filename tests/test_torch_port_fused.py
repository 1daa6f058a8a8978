"""Port parity: ``conv_backend: "pallas_fused"`` and ``"pallas"`` against the
JAX package, block and whole model.

- One ``DoubleConv(128 → 64)`` under ``pallas_fused`` (K4 forward with the
  folded BatchNorm, K5/K6 backward, here through their plain versions)
  against the JAX ``DoubleConv(conv_backend="pallas_fused")`` on the same
  weights, one train step at (2, 16, 16, 128): every gradient within 2e-4
  relative L2 and the updated BatchNorm running statistics within 1e-5,
  the JAX package's own block bars (``tests/test_pallas_conv.py:222-256``).
  A conv bias that a BatchNorm follows has an exact gradient of 0, so, as
  there, each error is taken relative to max(‖want‖, 1% of the whole
  gradient's norm).
- The UNet + quantile head at 16², batch 2, built by ``build_trunk`` /
  ``add_uncertainty`` and loaded with ``load_jax_variables``:
  - the eval forward in f32 against the JAX package's (Pallas kernels in
    interpret mode) within 1e-4 relative L2 under ``pallas_fused`` and 2e-4
    under ``pallas`` (``test_pallas_conv.py:98-117``);
  - one step of ``make_train_step`` in f64 against the JAX train step in
    f64 under ``conv_backend: "xla"``: the JAX fused path does not run in
    f64 (its XLA fallback asks for f32 accumulation,
    ``pallas_conv.py:469-478``), and the two backends compute one function
    (the fused BatchNorm's variance E[y²] − E[y]² and the two-pass one
    agree in f64 far inside the bars); bars in the test;
  - the port's f32 step against that f64 step with the JAX package's
    tripwire bars (``test_pallas_conv.py:283-321``: 1.5e-1 per tensor, 6e-2
    for the whole gradient, 1e-3 on the running statistics), since ReLU
    masks that flip on f32 noise amplify through 20 layers. The JAX
    package's own f32 steps sit farther from the f64 step (past the 6e-2
    whole-gradient bar here, under both its backends), so they are not the
    reference.
- The state-dict keys are the same under the three backends, so JAX weights
  of any backend load with ``strict=True``.
- ``chip_smoke.conv_sites``, the conv launches of a train step that the
  script holds against the plain versions and sums per step, are the
  launches that the port's UNet makes.
"""

from __future__ import annotations

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.models.unet import DoubleConv as JDoubleConv
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.interop.from_jax import _double_conv, load_jax_variables, state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.models.unet import DoubleConv
from im2im_uq_tpu_torch.ops import conv as tconv
from im2im_uq_tpu_torch.ops import conv_bwd as tbwd
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(
    DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
    lane_pack=False, dataset="synthetic", batch_size=2, lr=1e-3,
)


def _rel_l2(got, want, floor: float = 0.0) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


# ------------------------------------------------------------------ block


def test_fused_double_conv_block_matches_jax():
    x = np.random.RandomState(9).randn(2, 16, 16, 128).astype(np.float32)
    y = np.random.RandomState(10).randn(2, 16, 16, 64).astype(np.float32)
    jm = JDoubleConv(64, conv_backend="pallas_fused")
    vs = jm.init(jax.random.key(0), jnp.asarray(x), train=False)

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": vs["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2), upd["batch_stats"]

    (_, stats), grads = jax.value_and_grad(loss, has_aux=True)(vs["params"])
    want: dict = {}
    _double_conv(want, "double_conv.", _np(grads), _np(stats))

    block = DoubleConv(128, 64, conv_backend="pallas_fused")
    init: dict = {}
    _double_conv(init, "double_conv.", _np(vs["params"]), _np(vs["batch_stats"]))
    block.load_state_dict(init, strict=True)
    out = block.train()(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    (out - torch.from_numpy(np.ascontiguousarray(y.transpose(0, 3, 1, 2)))).square().mean().backward()

    params = dict(block.named_parameters())
    floor = 0.01 * float(np.sqrt(sum(float(want[n].double().square().sum()) for n in params)))
    for n, p in params.items():
        assert _rel_l2(p.grad, want[n], floor) < 2e-4, (n, _rel_l2(p.grad, want[n], floor))
    for n, b in block.named_buffers():
        if "running" in n:
            assert _rel_l2(b, want[n]) < 1e-5, n
        else:  # num_batches_tracked counts the step, as nn.BatchNorm2d's does
            assert int(b) == 1, n


# ------------------------------------------------------------ whole model


def _randomise_stats(stats, rng: np.random.RandomState):
    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _batch():
    ds = SyntheticDataset(num_examples=2, image_size=16, seed=21)
    return (np.stack([ds[i][0] for i in range(2)]), np.stack([ds[i][1] for i in range(2)]),
            np.ones((2,), np.float32))


def _port_step(cfg: dict, variables: dict, batch, dtype) -> tuple:
    """(loss, gradients, running statistics) of one ``make_train_step``."""
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    tstate.model.to(dtype)
    opt = torch.optim.Adam(tstate.model.parameters(), lr=cfg["lr"])
    step = ttrain.make_train_step(tstate.model, theads.head_loss_pe_fn("quantiles"), cfg, opt)
    loss = float(step(*(t.to(dtype) for t in ttrain.put_batch(*batch, torch.device("cpu")))))
    return (loss, {n: p.grad.double() for n, p in tstate.model.named_parameters()},
            {n: b.double() for n, b in tstate.model.named_buffers() if "running" in n})


def _run(conv_backend: str) -> dict:
    """From one init: the eval outputs of the JAX package and of the port
    in f32, and one train step of the JAX package in f64 and of the port in
    f64 and f32."""
    cfg = dict(CFG, conv_backend=conv_backend)
    jstate = jasm.add_uncertainty(jasm.build_trunk(cfg), cfg, rng=jax.random.key(0),
                                  example_input=jnp.zeros((2, 16, 16, 1)))
    v = _np(dict(jstate.variables))
    v = {"params": v["params"],
         "batch_stats": _randomise_stats(v["batch_stats"], np.random.RandomState(1))}
    jstate = jstate.replace(variables=jax.tree_util.tree_map(jnp.asarray, v))
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    load_jax_variables(tstate.model, v, "UNet", "quantiles")
    batch = _batch()
    x = batch[0]
    out = {
        "jax_eval": np.asarray(jstate.forward(jnp.asarray(x))),
        "port_eval": tstate.forward(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))).permute(0, 1, 3, 4, 2).numpy(),
        "port64": _port_step(cfg, v, batch, torch.float64),
        "port32": _port_step(cfg, v, batch, torch.float32),
    }
    with jax.enable_x64(True):
        tx = optax.adam(cfg["lr"])
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        xla = dict(cfg, conv_backend="xla")  # the same parameter tree
        model = jasm.add_uncertainty(jasm.build_trunk(xla), xla, rng=jax.random.key(0),
                                     example_input=jnp.zeros((2, 16, 16, 1))).model
        step = jax.jit(jtrain._train_step_body(model, jheads.head_loss_pe_fn("quantiles"),
                                               xla, tx))
        state = jtrain.TrainState(params=v64["params"], batch_stats=v64["batch_stats"],
                                  opt_state=tx.init(v64["params"]),
                                  step=jnp.zeros((), jnp.int32))
        state, loss, grads = step(state, *(jnp.asarray(a, jnp.float64) for a in batch))
        out["jax64_loss"] = float(loss)
        exported = state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, jax.device_get(grads)),
             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   jax.device_get(state.batch_stats))},
            "UNet", "quantiles")
    out["jax64"] = {n: t.double() for n, t in exported.items()}
    return out


@pytest.fixture(scope="module", params=["pallas_fused", "pallas"])
def model_pair(request):
    return request.param, _run(request.param)


def test_eval_forward_matches_jax(model_pair):
    backend, r = model_pair
    assert r["port_eval"].shape == r["jax_eval"].shape == (2, 3, 16, 16, 1)
    bar = 1e-4 if backend == "pallas_fused" else 2e-4
    assert _rel_l2(r["port_eval"], r["jax_eval"]) < bar


def _feeds_batchnorm(name: str) -> bool:
    return re.search(r"double_conv\.[03]\.bias$", name) is not None


def test_train_step_in_f64_matches_jax(model_pair):
    """The same step in f64 on both sides pins the semantics: the loss to
    1e-12, every gradient to 1e-6 relative L2 (a conv bias that a BatchNorm
    follows, whose exact gradient is 0, to 1e-9 of its conv's weight
    gradient), the running statistics to 1e-9."""
    _, r = model_pair
    loss, got, stats = r["port64"]
    want = r["jax64"]
    np.testing.assert_allclose(loss, r["jax64_loss"], rtol=1e-12)
    assert len(got) == 80 and len(stats) == 36
    for n, g in got.items():
        if _feeds_batchnorm(n):
            assert (g - want[n]).norm() <= 1e-9 * want[n[:-4] + "weight"].norm(), n
        else:
            assert (g - want[n]).norm() <= 1e-6 * want[n].norm(), n
    for n, s in stats.items():
        assert _rel_l2(s, want[n]) < 1e-9, n


def test_train_step_in_f32_is_within_the_tripwire_of_jax_f64(model_pair):
    _, r = model_pair
    loss, got, stats = r["port32"]
    want = r["jax64"]
    np.testing.assert_allclose(loss, r["jax64_loss"], rtol=1e-5)
    tree = float(np.sqrt(sum(float(want[n].square().sum()) for n in got)))
    num = 0.0
    for n, g in got.items():
        assert _rel_l2(g, want[n], 0.01 * tree) < 1.5e-1, n
        num += float((g - want[n]).square().sum())
    assert num ** 0.5 / tree < 6e-2
    for n, s in stats.items():
        assert _rel_l2(s, want[n]) < 1e-3, n


def test_state_dict_keys_are_the_same_under_every_conv_backend():
    keys = []
    for backend in ("xla", "pallas", "pallas_fused", "auto"):
        cfg = dict(CFG, conv_backend=backend)
        keys.append(list(tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
                         .model.state_dict()))
    assert all(k == keys[0] for k in keys[1:])
    assert "baseModel.up1.conv.double_conv.4.num_batches_tracked" in keys[0]


@pytest.mark.parametrize(
    "override, error",
    [({"conv_backend": "cudnn"}, ValueError), ({"bn_backend": "cudnn"}, ValueError),
     ({"conv_backend": "pallas_fused", "bn_backend": "dot"}, ValueError),
     ({"bn_backend": "dot"}, NotImplementedError)],
)
def test_build_trunk_refuses_what_the_jax_package_refuses_or_the_port_lacks(override, error):
    with pytest.raises(error):
        tasm.build_trunk(dict(CFG, **override))


@pytest.mark.parametrize("conv_backend", ["pallas_fused", "pallas"])
def test_chip_smoke_conv_sites_are_the_models_launches(conv_backend, monkeypatch):
    """One train step of the port's UNet at 32² (a tenth of 320²) and batch
    2 calls the K3-K6 wrappers at the channel counts, prologues and sides
    (a tenth) of ``chip_smoke.conv_sites``, as often."""
    import chip_smoke

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
    cfg = dict(CFG, conv_backend=conv_backend)
    model = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu").model.train()
    model(torch.randn(2, 1, 32, 32)).square().mean().backward()

    names = {"conv3x3": "conv3x3_fwd", "conv3x3_bn_act": "conv3x3_bn_act_fwd",
             "wgrad3x3": "wgrad3x3", "dgrad3x3": "dgrad3x3"}
    want: collections.Counter = collections.Counter()
    for kernel, sites in chip_smoke.conv_sites(conv_backend).items():
        for (_, cin, h, w, cout), prologue in sites:
            want[names[kernel], ((2, cin, h // 10, w // 10, cout), prologue)] += 1
    assert calls == want
    assert sum(want.values()) == {"pallas_fused": 49, "pallas": 22}[conv_backend]
