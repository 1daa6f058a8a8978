"""Port parity: losses, the train step, eval_net, checkpoints and shutdown.

The train step runs against the JAX package's on identical batches (four
synthetic 32x32 images, the last one masked) from one exported init
(``resize_backend: "xla"``, ``lane_pack: False``; the JAX step is
``_train_step_body``, the body that ``make_train_step`` jits). Both sides
also run the first step in float64 (``jax.enable_x64`` on the JAX side).
Tolerances, with what was measured:

- the same step in f64 on both sides: every gradient within 1e-6 relative
  L2 (measured 4e-8), which pins the semantics (K1b and K7 plain versions,
  BatchNorm, the loss and its mask). A conv bias that a BatchNorm follows
  has an exact gradient of 0 (the BatchNorm subtracts the batch mean), so
  both sides hold rounding noise there, held to 1e-9 of the same conv's
  weight gradient (measured 2e-15);
- the f32 step against the f64 one: the loss to 1e-5, the gradient norms
  (the ``watch_gradients`` log) to 1e-3 (measured 2e-5), and the gradient
  as a whole to 5e-2 relative L2 (measured 1.4e-2). The gradient is a
  discontinuous function of the forward (ReLU, max-pool and pinball
  kinks), and at the 2x2 and 4x4 levels of a 32x32 input f32 rounding puts
  some units on the other side of a kink than f64 does; per tensor this
  reaches a few percent, which is why f32 gradients are not compared per
  tensor. The JAX f32 step is further off (its BatchNorm takes the batch
  variance as E[x²] − E[x]², flax's ``use_fast_variance``);
- BatchNorm running statistics after step 1, f32 against f64: 1e-5
  (measured 6e-7);
- the losses of three f32 steps against the JAX f32 steps: rtol 2e-2
  (measured 4e-3). Adam moves every parameter by about lr·sign(g) at step
  1, so a gradient element near 0 can move the two sides' parameters 2·lr
  apart; the raw parameters are therefore not compared.
"""

from __future__ import annotations

import json
import os
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.interop.torch_export import export_state_dict
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.ops import losses as jlosses
from im2im_uq_tpu.training import checkpoint as jckpt
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS
from im2im_uq_tpu.utils.logging import MetricsLogger

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.ops import losses as tlosses
from im2im_uq_tpu_torch.scripts import router as trouter
from im2im_uq_tpu_torch.training import checkpoint as tckpt
from im2im_uq_tpu_torch.training import train as ttrain
from im2im_uq_tpu_torch.utils.random import fix_randomness
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(
    DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
    lane_pack=False, dataset="synthetic", batch_size=4, lr=1e-3,
)
STEPS = 3


def _rng(seed):
    return np.random.RandomState(seed)


def _nhwc_to_nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# --------------------------------------------------------------- losses


@pytest.mark.parametrize("q", [0.05, 0.5, 0.95])
def test_pinball_se_ae_match_jax(q):
    r = _rng(0)
    pred, target = r.randn(2, 3, 5).astype(np.float32), r.randn(2, 3, 5).astype(np.float32)
    pred[0, 0, :2] = target[0, 0, :2]  # exact zeros of the error
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    pairs = [
        (tlosses.pinball_elem(tp, tt, q), jlosses.pinball_elem(jp, jt, q)),
        (tlosses.se_elem(tp, tt), jlosses.se_elem(jp, jt)),
        (tlosses.ae_elem(tp, tt), jlosses.ae_elem(jp, jt)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tf, jf in ((tlosses.pinball, jlosses.pinball),):
        np.testing.assert_allclose(float(tf(tp, tt, q)), float(jf(jp, jt, q)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.mse(tp, tt)), float(jlosses.mse(jp, jt)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.l1(tp, tt)), float(jlosses.l1(jp, jt)), rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.per_example_mean(tp).numpy(), np.asarray(jlosses.per_example_mean(jp)), rtol=1e-6
    )


def test_gaussian_nll_and_interval_score_match_jax():
    r = _rng(1)
    mean, target = r.randn(4, 6).astype(np.float32), r.randn(4, 6).astype(np.float32)
    var = np.abs(r.randn(4, 6)).astype(np.float32)
    var[0, :3] = [0.0, 1e-8, -1.0]  # clamped to eps
    lo, hi = mean - 0.5, mean + np.abs(r.randn(4, 6)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (mean, target, var, lo, hi)]
    j = [jnp.asarray(a) for a in (mean, target, var, lo, hi)]
    np.testing.assert_allclose(
        tlosses.gaussian_nll_elem(t[0], t[1], t[2]).numpy(),
        np.asarray(jlosses.gaussian_nll_elem(j[0], j[1], j[2])), rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.interval_score_elem(t[3], t[4], t[1], 0.1).numpy(),
        np.asarray(jlosses.interval_score_elem(j[3], j[4], j[1], 0.1)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tlosses.gaussian_nll(t[0], t[1], t[2])),
        float(jlosses.gaussian_nll(j[0], j[1], j[2])), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.interval_score(t[3], t[4], t[1], 0.1)),
        float(jlosses.interval_score(j[3], j[4], j[1], 0.1)), rtol=1e-6)


def _grads(tfn, jfn, arrays):
    """The gradients of Σ tfn and Σ jfn with respect to every array."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tfn(*ts).sum().backward()
    want = jax.grad(lambda *a: jfn(*a).sum(), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return [t.grad.numpy() for t in ts], [np.asarray(w) for w in want]


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_abs_gradient_at_zero_matches_jax(zero):
    """jnp.abs has the derivative +1 at ±0; the port's |·| too (Tensor.abs
    has 0 there): pred = target = ±0 in a (1, 2, 2) map gives d ae_elem /
    d pred = 1 per element, and the interval score with lower = upper =
    target = ±0 gives d / d upper = beta. The values are those of abs."""
    z = np.full((1, 2, 2), zero, np.float32)
    got, want = _grads(tlosses.ae_elem, jlosses.ae_elem, [z, z.copy()])
    np.testing.assert_array_equal(got[0], np.ones_like(z))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got, want = _grads(lambda lo, up, t: tlosses.interval_score_elem(lo, up, t, 0.3),
                       lambda lo, up, t: jlosses.interval_score_elem(lo, up, t, 0.3),
                       [z, z.copy(), z.copy()])
    np.testing.assert_array_equal(got[1], np.full_like(z, np.float32(0.3)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    value = tlosses.absolute(torch.from_numpy(z))
    assert torch.equal(value, torch.from_numpy(z).abs()) and not value.signbit().any()


def test_gaussian_nll_gradient_at_the_eps_tie_matches_jax():
    """var == eps exactly: jnp.maximum sends half the gradient to var (0.5),
    torch.clamp would send all of it; below eps none, above all."""
    mean = np.array([[0.1, 0.2, 0.3]], np.float32)
    target = np.array([[0.15, 0.1, 0.4]], np.float32)
    var = np.array([[1e-6, 1e-7, 2e-6]], np.float32)
    got, want = _grads(tlosses.gaussian_nll_elem, jlosses.gaussian_nll_elem, [mean, target, var])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    full = 0.5 * (1.0 / 1e-6 - (0.15 - 0.1) ** 2 / 1e-12)
    np.testing.assert_allclose(got[2][0, 0], 0.5 * full, rtol=1e-5)
    assert got[2][0, 1] == 0.0


@pytest.mark.parametrize("num_classes", [2, 7, 50, 1000])
def test_bucketize_targets_matches_jax(num_classes):
    r = _rng(2)
    target = r.rand(3, 40).astype(np.float32)
    # the exact class boundaries, and values one ulp either side of them
    bounds = np.asarray(jnp.linspace(0.0, 1.0, num_classes, dtype=jnp.float32))
    edge = np.clip(np.concatenate([bounds, np.nextafter(bounds, 2), np.nextafter(bounds, -1)]), 0, 1)
    # XLA on the CPU flushes subnormals to zero; a target is never one
    edge = edge[(edge == 0) | (edge >= np.finfo(np.float32).tiny)]
    target = np.concatenate([target.ravel(), edge]).astype(np.float32)
    got = tlosses.bucketize_targets(torch.from_numpy(target), num_classes).numpy()
    want = np.asarray(jlosses.bucketize_targets(jnp.asarray(target), num_classes))
    np.testing.assert_array_equal(got, want)


def test_softmax_cross_entropy_matches_jax():
    r = _rng(3)
    logits = r.randn(2, 5, 3, 4).astype(np.float32)
    labels = r.randint(0, 5, (2, 3, 4))
    got = tlosses.softmax_cross_entropy_elem(torch.from_numpy(logits), torch.from_numpy(labels), 1)
    want = jlosses.softmax_cross_entropy_elem(jnp.asarray(logits), jnp.asarray(labels), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("utype", ["quantiles", "quantiles_l1", "inn", "gaussian",
                                   "residual_magnitude", "residual_magnitude_l1", "softmax"])
def test_head_losses_match_jax(utype):
    """The port's head output is (B, K, C, H, W), the JAX one (B, K, H, W, C);
    the softmax head's K is its 3 classes here. Gaussian variances below
    eps are clamped."""
    r = _rng(4)
    pred = r.randn(3, 3, 2, 5, 6).astype(np.float32)  # (B, K, C, H, W)
    target = r.rand(3, 2, 5, 6).astype(np.float32)  # (B, C, H, W)
    params = dict(DEFAULTS, q_lo_weight=0.7, q_hi_weight=1.3, mse_weight=2.0, beta=0.3,
                  num_softmax=3)
    got = theads.head_loss_pe_fn(utype)(torch.from_numpy(pred), torch.from_numpy(target), params)
    want = jheads.head_loss_pe_fn(utype)(
        jnp.asarray(np.moveaxis(pred, 2, -1)), jnp.asarray(np.moveaxis(target, 1, -1)), params
    )
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_unported_head_loss_raises():
    """Every head's loss is ported; an unknown type raises as the JAX
    package's ``head_loss_pe_fn`` does."""
    for fn in (jheads.head_loss_pe_fn, theads.head_loss_pe_fn):
        with pytest.raises(NotImplementedError, match="unknown uncertainty_type 'bogus'"):
            fn("bogus")


# ----------------------------------------------------------- train step


def _batches():
    """STEPS batches of 4 synthetic 32x32 images; the last example masked."""
    out = []
    for k in range(STEPS):
        ds = SyntheticDataset(num_examples=4, image_size=32, seed=10 + k)
        x = np.stack([ds[i][0] for i in range(4)])
        y = np.stack([ds[i][1] for i in range(4)])
        out.append((x, y, np.array([1, 1, 1, 0], np.float32)))
    return out


def _export(tree: dict, stats: dict) -> dict:
    np_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(tree))
    np_stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(stats))
    return {k: v.double() for k, v in
            export_state_dict({"params": np_tree, "batch_stats": np_stats}, "UNet", "quantiles").items()}


def _jax_steps(model, variables, batches, dtype):
    """(losses, exported step-1 gradients and BN statistics) of the JAX step."""
    tx = optax.adam(CFG["lr"])
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
    step = jax.jit(jtrain._train_step_body(model, jheads.head_loss_pe_fn("quantiles"), CFG, tx))
    state = jtrain.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    losses, first = [], None
    for x, y, m in batches:
        state, loss, grads = step(state, *(jnp.asarray(a, dtype) for a in (x, y, m)))
        losses.append(float(loss))
        if first is None:
            first = _export(grads, state.batch_stats)
    return losses, first


def _port_steps(variables, batches, dtype):
    """(losses, step-1 gradients, BN statistics and grad norms) of the port."""
    tstate = tasm.add_uncertainty(tasm.build_trunk(dict(CFG, pool_backend="pallas")), CFG,
                                 device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    tstate.model.to(dtype)
    opt = torch.optim.Adam(tstate.model.parameters(), lr=CFG["lr"])
    step = ttrain.make_train_step(
        tstate.model, theads.head_loss_pe_fn("quantiles"), dict(CFG, watch_gradients=True), opt
    )
    losses, first = [], None
    for batch in batches:
        loss, norms = step(*(t.to(dtype) for t in ttrain.put_batch(*batch, torch.device("cpu"))))
        losses.append(float(loss))
        if first is None:
            grads = {n: p.grad.double() for n, p in tstate.model.named_parameters()}
            stats = {n: b.double() for n, b in tstate.model.state_dict().items() if "running" in n}
            first = (grads, stats, {k: float(v) for k, v in norms.items()})
    return losses, first


@pytest.fixture(scope="module")
def train_pair():
    jstate = jasm.add_uncertainty(
        jasm.build_trunk(CFG), CFG, rng=jax.random.key(0), example_input=jnp.zeros((1, 32, 32, 1))
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    batches = _batches()
    out = {
        "jax32": _jax_steps(jstate.model, variables, batches, jnp.float32),
        "port32": _port_steps(variables, batches, torch.float32),
        "port64": _port_steps(variables, batches[:1], torch.float64),
        "variables": variables,
    }
    with jax.enable_x64(True):
        out["jax64"] = _jax_steps(jstate.model, variables, batches[:1], jnp.float64)
    return out


def _feeds_batchnorm(name: str) -> bool:
    return re.search(r"double_conv\.[03]\.bias$", name) is not None


def test_step1_loss_matches_jax(train_pair):
    t32, t64 = train_pair["port32"][0][0], train_pair["port64"][0][0]
    np.testing.assert_allclose(t32, train_pair["jax32"][0][0], rtol=1e-5)
    np.testing.assert_allclose(t32, train_pair["jax64"][0][0], rtol=1e-5)
    np.testing.assert_allclose(t64, train_pair["jax64"][0][0], rtol=1e-12)


def test_step1_gradients_match_jax_in_f64(train_pair):
    got, want = train_pair["port64"][1][0], train_pair["jax64"][1]
    fed = [n for n in got if _feeds_batchnorm(n)]
    assert len(got) == 80 and len(fed) == 18
    for n, g in got.items():
        if n in fed:  # exact gradient 0: noise, beside the conv's weight gradient
            assert (g - want[n]).norm() <= 1e-9 * want[n[:-4] + "weight"].norm(), n
        else:
            assert (g - want[n]).norm() <= 1e-6 * want[n].norm(), n


def test_step1_gradient_norms_in_f32_match_jax_f64(train_pair):
    """The f32 step's gradient as a whole (the watch_gradients norms)."""
    grads = train_pair["jax64"][1]
    names = list(train_pair["port64"][1][0])

    def norm(keys):
        return float(np.sqrt(sum(float(grads[k].square().sum()) for k in keys)))

    want = {
        "grad_norm/global": norm(names),
        "grad_norm/trunk": norm([n for n in names if n.startswith("baseModel.")]),
        "grad_norm/head": norm([n for n in names if n.startswith("last_layer.")]),
    }
    got = train_pair["port32"][1][2]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    delta = np.sqrt(sum(float((train_pair["port32"][1][0][n] - grads[n]).square().sum())
                        for n in names))
    assert delta <= 5e-2 * want["grad_norm/global"]


def test_step1_batchnorm_running_stats_match_jax_f64(train_pair):
    want = train_pair["jax64"][1]
    stats = train_pair["port32"][1][1]
    assert len(stats) == 36
    for n, v in stats.items():
        assert ((v - want[n]).norm() / want[n].norm()).item() <= 1e-5, n


def test_losses_of_three_steps_match_jax(train_pair):
    np.testing.assert_allclose(train_pair["port32"][0], train_pair["jax32"][0], rtol=2e-2)


def test_masked_mean_ignores_padding_and_empty_masks():
    pe = torch.tensor([1.0, 2.0, 30.0])
    assert float(ttrain._masked_mean(pe, torch.tensor([1.0, 1.0, 0.0]))) == 1.5
    assert float(ttrain._masked_mean(pe, torch.zeros(3))) == 0.0
    np.testing.assert_allclose(
        float(ttrain._masked_mean(pe, torch.tensor([1.0, 0.0, 1.0]))),
        float(jtrain._masked_mean(jnp.asarray(pe.numpy()), jnp.asarray([1.0, 0.0, 1.0]))),
    )


def test_eval_net_matches_jax(train_pair):
    variables = train_pair["variables"]
    jstate = jasm.add_uncertainty(jasm.build_trunk(CFG), CFG).replace(
        variables=jax.tree_util.tree_map(jnp.asarray, variables)
    )
    tstate = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    ds = SyntheticDataset(num_examples=6, image_size=32, seed=20)  # last batch padded
    want = jtrain.eval_net(jstate, ds, 4)
    got = ttrain.eval_net(tstate, ds, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------- checkpoints and resume


SMALL = dict(CFG, resize_backend="auto", num_examples=8)


def _small_state(seed=0):
    return tasm.add_uncertainty(tasm.build_trunk(SMALL), SMALL,
                                generator=torch.Generator().manual_seed(seed), device="cpu")


def _small_ds():
    return SyntheticDataset(num_examples=8, image_size=16, seed=30)


def _train(state, ckpt_dir, epochs, **kw):
    cfg = dict(SMALL, **kw.pop("config", {}))
    return ttrain.train_net(state, _small_ds(), _small_ds(), None, epochs=epochs,
                            batch_size=4, lr=1e-3, checkpoint_dir=ckpt_dir, config=cfg, **kw)


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_checkpoint_names_follow_the_jax_stem(tmp_path):
    for e in (0, 3):
        jp = jckpt.checkpoint_path(str(tmp_path), e, SMALL)
        tp = tckpt.checkpoint_path(str(tmp_path), e, SMALL)
        assert jp.endswith(".msgpack") and tp == jp[: -len(".msgpack")] + ".pt"
    assert tckpt.checkpoint_key(SMALL) == jckpt.checkpoint_key(SMALL)


def test_save_restore_round_trip(tmp_path):
    state = _small_state()
    state = _train(state, str(tmp_path), 1)
    path = tckpt.checkpoint_path(str(tmp_path), 1, SMALL)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    fresh = _small_state(seed=1)
    fresh_opt = torch.optim.Adam(fresh.model.parameters(), lr=1e-3)
    lhat, epoch = tckpt.restore_checkpoint(path, fresh.model, fresh_opt)
    assert (lhat, epoch) == (None, 1)
    a, b = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert ttrain._optimizer_steps(fresh_opt) == 2  # 8 images, batch 4, one epoch
    tckpt.save_checkpoint(path, fresh.model, fresh_opt, 2.5, 7)
    assert tckpt.restore_checkpoint(path, fresh.model, fresh_opt) == (2.5, 7)


def test_find_resume_checkpoint_probe_order(tmp_path):
    d = str(tmp_path)
    assert tckpt.find_resume_checkpoint(d, 4, SMALL) == (None, 0)
    for e in (0, 2):
        open(tckpt.checkpoint_path(d, e, SMALL), "wb").close()
    assert tckpt.find_resume_checkpoint(d, 4, SMALL) == (tckpt.checkpoint_path(d, 2, SMALL), 2)
    open(tckpt.checkpoint_path(d, 4, SMALL), "wb").close()
    assert tckpt.find_resume_checkpoint(d, 4, SMALL) == (tckpt.checkpoint_path(d, 4, SMALL), 4)


def test_resume_short_circuits_at_the_final_checkpoint(tmp_path, monkeypatch):
    trained = _train(_small_state(), str(tmp_path), 2)
    want = _params(trained)

    def no_training(*a, **k):
        raise AssertionError("a finished run must not build a train step")

    monkeypatch.setattr(ttrain, "make_train_step", no_training)
    resumed = _train(_small_state(seed=1), str(tmp_path), 2, load_from_checkpoint=True)
    got = _params(resumed)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_resume_from_an_intermediate_epoch(tmp_path):
    _train(_small_state(), str(tmp_path), 1, checkpoint_every=1)
    log_dir = tmp_path / "log"
    logger = MetricsLogger(str(log_dir), use_wandb=False)
    _train(_small_state(seed=1), str(tmp_path), 3, load_from_checkpoint=True, logger=logger)
    logger.close()
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    epochs = sorted({r["epoch"] for r in records if "train_loss" in r})
    assert epochs == [1, 2]
    assert {r["iter"] for r in records if "train_loss" in r} == {4, 6}
    timing = [r for r in records if "time/epoch_s" in r]
    assert len(timing) == 2 and {"time/data_wait_s", "time/step_dispatch_s", "time/device_drain_s",
                                 "time/val_s", "time/checkpoint_s"} <= timing[0].keys()


def test_steps_train_batchnorm_after_a_validation_hook(tmp_path):
    """UQState.forward leaves the model in eval mode; the next step must
    still train on batch statistics and update the running ones."""
    calls = []

    def hook(current, epoch, step):
        current.forward(torch.zeros((1, 1, 16, 16)))
        calls.append(current.model.training)

    state = _train(_small_state(), None, 3, validate_every=1, validation_hook=hook)
    assert calls == [False, False, False]
    bn = state.model.baseModel.inc.double_conv[1]
    assert int(bn.num_batches_tracked) == 6  # 3 epochs × 2 steps, all in train mode


class _SmallStream:
    """``_small_ds`` as a stream (no ``__len__``, no ``__getitem__``), as
    TEMCA's dataset is."""

    def __iter__(self):
        ds = _small_ds()
        return (ds[i] for i in range(len(ds)))


@pytest.mark.parametrize(
    "kw",
    [
        {"mesh": object()},
        {"preprocess": abs, "preprocess_pair": abs},
        {"config": {"input_pipeline": "grain"}, "train": _SmallStream()},
        {"config": {"loader_procs": 2}, "train": _SmallStream()},
        {"config": {"precompile_calibration": True}},
    ],
)
def test_unported_training_options_raise(kw):
    """The option that is not ported (``precompile_calibration``) raises; a
    mesh is ported (``test_torch_port_parallel.py``), and anything but a
    ``parallel.mesh.Mesh`` or None in its place is a TypeError. The
    on-device hooks, ``loader_procs`` and ``input_pipeline: grain`` are
    ported (``test_torch_port_device_transforms.py``,
    ``test_torch_port_data_extras.py``, ``test_torch_port_grain.py``): what
    they still refuse raises the JAX package's ValueError, both hooks at
    once, and worker processes or grain for a stream dataset."""
    kw = dict(kw)
    mesh = kw.pop("mesh", None)
    train = kw.pop("train", _small_ds())
    if mesh is not None:
        expected = pytest.raises(TypeError, match="Mesh")
    elif "preprocess" in kw:
        expected = pytest.raises(ValueError, match="pass preprocess OR preprocess_pair, not both")
    elif "loader_procs" in kw["config"]:
        expected = pytest.raises(ValueError, match="loader_procs requires a map-style dataset")
    elif "input_pipeline" in kw["config"]:
        expected = pytest.raises(ValueError, match="grain requires a map-style dataset")
    else:
        expected = pytest.raises(NotImplementedError, match="not yet ported")
    with expected:
        ttrain.train_net(_small_state(), train, _small_ds(), mesh, epochs=1, batch_size=4,
                         lr=1e-3, config=dict(SMALL, **kw.pop("config", {})), **kw)


class _SignalingDataset:
    """Sends SIGTERM to the current process on one example access."""

    def __init__(self, dataset, signal_index):
        self.dataset, self.signal_index = dataset, signal_index
        self.sent = False

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        if i == self.signal_index and not self.sent:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return self.dataset[i]


def test_sigterm_checkpoints_at_the_epoch_end_and_resume_matches(tmp_path):
    cfg = {"graceful_shutdown": True}
    full = _train(_small_state(), str(tmp_path / "full"), 2, config=cfg)
    d = str(tmp_path / "interrupted")
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(ttrain.PreemptionInterrupt) as exc:
        ttrain.train_net(_small_state(), _SignalingDataset(_small_ds(), 5), _small_ds(), None,
                         epochs=2, batch_size=4, lr=1e-3, checkpoint_dir=d,
                         checkpoint_every=5, config=dict(SMALL, **cfg))
    assert signal.getsignal(signal.SIGTERM) == before  # handlers restored
    assert exc.value.checkpoint_path == tckpt.checkpoint_path(d, 1, SMALL)
    assert os.path.exists(exc.value.checkpoint_path)
    resumed = _train(_small_state(seed=3), d, 2, config=cfg, load_from_checkpoint=True)
    a, b = _params(full), _params(resumed)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)


def test_router_exits_143_on_preemption(tmp_path, monkeypatch):
    def preempted(*a, **k):
        raise ttrain.PreemptionInterrupt("somewhere")

    monkeypatch.setattr(trouter, "train_net", preempted)
    cfg = dict(SMALL, data_split_percentages=[0.5, 0.25, 0.25, 0.0], epochs=1,
               output_dir=str(tmp_path), image_size=16)
    with pytest.raises(SystemExit) as exc:
        trouter.run_experiment(cfg, "cpu")
    assert exc.value.code == 143


def test_fix_randomness_seeds_every_rng():
    import random

    g = fix_randomness(7)
    a = (np.random.rand(), random.random(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    g = fix_randomness(7)
    b = (np.random.rand(), random.random(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    assert a == b and isinstance(g, torch.Generator)
