"""Port parity: the gaussian, residual_magnitude, residual_magnitude_l1 and
softmax heads against the JAX package.

For each head, the UNet + head of the port (torch's default init from a
seeded generator, BatchNorm running statistics randomised as in
``test_torch_port_model.py``) is carried into the JAX package's variables by
its ``interop/torch_import.port_state_dict`` and back into a second port
model by ``load_jax_variables`` (strict): both sides hold the same exported
weights. Inputs come from seeded RandomStates.

- The eval forward at (2, 24, 32): rtol 1e-4, atol 1e-5, the tolerance of
  ``test_forward_matches_jax``.
- The nested sets at λ = 1.3 from the port's ``nested_sets`` against the
  JAX sets of the JAX forward: the same tolerance. The softmax head by the
  rule below.
- One train step in f64 on both sides (the JAX trunk, head and loss, see
  ``jax_trunk``; the port's ``make_train_step``) at (2, 16, 16): the loss
  to 1e-12, every
  gradient to 1e-6 relative L2 (a conv bias that a BatchNorm follows, whose
  exact gradient is 0, to 1e-9 of its conv's weight gradient), the running
  statistics to 1e-9, as ``test_torch_port_fused.py`` holds the UNet.
- The router on ``experiments/synthetic_test/config.yml`` with
  ``uncertainty_type`` overridden (16 images of 32², one epoch, L = 20), on
  both sides with a stand-in model whose output is the same function of the
  input, by correctly rounded operations only, and whose one parameter does
  not move (its gradient is 0): the same artifact names and results keys and
  types, and λ̂ and the loss table equal (the softmax head by the rule).

The softmax rule. ``jnp.cumsum`` and ``torch.cumsum`` (and the two
softmaxes) round differently, so a pixel whose cumulative softmax lies
within rounding of 0.05 or 0.95 can count one bin more or less. Every
pixel's prediction agrees; a slope may differ only at a pixel whose JAX cdf
at some bin lies within S·2^-24 of a threshold (each side's S additions
round by at most half an ulp of a partial sum below 1; this holds 4 f32
ulps of either threshold at S = 50, and at S = 1000 a pixel 5 ulps from
0.05 was seen to differ), and there by exactly 1/S; a loss table may
differ only in the rows of examples that hold such a pixel.
"""

from __future__ import annotations

import os
import pickle
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from im2im_uq_tpu.interop.torch_import import port_state_dict
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.ops import sets as jsets
from im2im_uq_tpu.parallel.mesh import data_parallel_mesh
from im2im_uq_tpu.scripts import router as jrouter
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS, load_config

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables, state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.ops import sets as tsets
from im2im_uq_tpu_torch.scripts import router as trouter
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

HEADS = ("gaussian", "residual_magnitude", "residual_magnitude_l1", "softmax")
CFG = dict(DEFAULTS, model="UNet", resize_backend="xla", lane_pack=False, dataset="synthetic",
           batch_size=2, lr=1e-3)
RTOL, ATOL = 1e-4, 1e-5
LAM = 1.3
ROUTER_CONFIG = "experiments/synthetic_test/config.yml"


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    """(B, [K,] C, H, W) → (B, [K,] H, W, C)."""
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _shared_variables(cfg: dict) -> dict:
    """JAX variables of a port model from a seeded init, its BatchNorm
    running statistics randomised (means ~N(0, 0.1), variances ~U(0.5, 2))."""
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                  generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for m in tstate.model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, m.num_features)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, m.num_features)))
    params, stats = port_state_dict(tstate.model.state_dict(), cfg["model"],
                                    cfg["uncertainty_type"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_trunk():
    """The JAX UNet's eval forward (f32) and, in f64, its train-mode forward
    with the VJP of a cotangent on its features, each jitted once: the
    heads' train steps share them. A head's step is this forward, the head
    and its loss by ``jax.value_and_grad``, and the trunk's VJP of the
    features' gradient: the chain rule of ``_train_step_body`` in two
    programs."""
    trunk = jasm.build_trunk(dict(CFG, uncertainty_type="quantiles"))
    evaluate = jax.jit(lambda v, x: trunk.apply(v, x, train=False))

    def fwd_vjp(params, stats, x, g):
        def fwd(p):
            feats, upd = trunk.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"])
            return feats, upd["batch_stats"]
        feats, vjp, new_stats = jax.vjp(fwd, params, has_aux=True)
        return feats, new_stats, vjp(g)[0]

    return evaluate, jax.jit(fwd_vjp)


def _batch(hw: int = 16):
    rng = np.random.RandomState(2)
    x = rng.randn(2, hw, hw, 1).astype(np.float32)
    y = rng.rand(2, hw, hw, 1).astype(np.float32)
    y[0, 0, :3, 0] = [0.0, 1.0, 0.5]  # the bins' ends
    return x, y, np.ones((2,), np.float32)


def _jax_step64(fwd_vjp, head, variables: dict, cfg: dict, batch) -> tuple:
    """(loss, gradients and running statistics in the port's layout) of one
    f64 train step of the JAX trunk + ``head``."""
    loss_pe = jheads.head_loss_pe_fn(cfg["uncertainty_type"])
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        x, y, mask = (jnp.asarray(a, jnp.float64) for a in batch)
        p, s = v["params"]["trunk"], v["batch_stats"]["trunk"]
        feats, new_stats, _ = fwd_vjp(p, s, x, jnp.zeros((2, 16, 16, 32), jnp.float64))

        def loss_of(hp, f):
            return jtrain._masked_mean(loss_pe(head.apply({"params": hp}, f), y, cfg), mask)

        loss, (g_head, g_feats) = jax.jit(jax.value_and_grad(loss_of, argnums=(0, 1)))(
            v["params"]["head"], feats)
        g_trunk = fwd_vjp(p, s, x, g_feats)[2]
        exported = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, {
                "params": {"trunk": g_trunk, "head": g_head},
                "batch_stats": {"trunk": new_stats}}),
            cfg["model"], cfg["uncertainty_type"])
    return float(loss), {n: t.double() for n, t in exported.items()}


def _port_step64(tstate: tasm.UQState, cfg: dict, batch) -> tuple:
    model = tstate.model.double()
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"])
    step = ttrain.make_train_step(model, theads.head_loss_pe_fn(cfg["uncertainty_type"]), cfg,
                                  opt)
    loss = float(step(*(t.double() for t in ttrain.put_batch(*batch, torch.device("cpu")))))
    return (loss, {n: p.grad.double() for n, p in model.named_parameters()},
            {n: b.double() for n, b in model.named_buffers() if "running" in n})


@pytest.fixture(scope="module", params=HEADS)
def head_run(request, jax_trunk):
    """One head: the eval forward and nested sets of both sides, and one f64
    train step of both sides, from the same weights."""
    evaluate, fwd_vjp = jax_trunk
    utype = request.param
    cfg = dict(CFG, uncertainty_type=utype)
    variables = _shared_variables(cfg)
    head = jheads.build_head(utype, 1, cfg)
    x = np.random.RandomState(3).randn(2, 24, 32, 1).astype(np.float32)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    feats = evaluate({"params": v["params"]["trunk"], "batch_stats": v["batch_stats"]["trunk"]},
                     jnp.asarray(x))
    j_out = jax.jit(head.apply)({"params": v["params"]["head"]}, feats)
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", utype)
    batch = _batch()
    return {
        "utype": utype,
        "jax_out": np.asarray(j_out),
        "jax_sets": [np.asarray(a) for a in jsets.nested_sets_from_output(j_out, LAM, utype)],
        "jax_params": [np.asarray(a) for a in jsets.interval_params(j_out, utype)],
        "jax_cdf": np.asarray(jnp.cumsum(jax.nn.softmax(j_out, axis=1), axis=1)),
        "port_out": _nhwc(tstate.forward(_nchw(x))),
        "port_sets": [_nhwc(a) for a in tstate.nested_sets(_nchw(x), lam=LAM)],
        "jax64": _jax_step64(fwd_vjp, head, variables, cfg, batch),
        "port64": _port_step64(tstate, cfg, batch),
    }


def _near_threshold(cdf: np.ndarray) -> np.ndarray:
    """(B, S, ...) JAX cdf → (B, ...): a bin within S·2^-24 of a threshold."""
    tol = cdf.shape[1] * 2.0 ** -24
    return ((np.abs(cdf - np.float32(0.05)) <= tol)
            | (np.abs(cdf - np.float32(0.95)) <= tol)).any(axis=1)


def _softmax_rule(got: list, want: list, cdf: np.ndarray, num_softmax: int) -> np.ndarray:
    """The rule of the module docstring for interval params (pred, dl, du)
    in NHWC: the predictions equal, a slope off only near a threshold, and
    there by 1/S → the pixels off."""
    np.testing.assert_array_equal(got[0], want[0])
    near = _near_threshold(cdf)
    off = np.zeros_like(near)
    for g, w in zip(got[1:], want[1:]):
        d = g != w
        assert not (d & ~near).any(), "a slope differs away from a threshold"
        # one bin, up to the rounding of the [0, 1] values subtracted
        np.testing.assert_allclose(np.abs(g - w)[d], 1.0 / num_softmax, rtol=0, atol=2.0 ** -23)
        off |= d
    return off


def test_forward_matches_jax(head_run):
    r = head_run
    k = 50 if r["utype"] == "softmax" else 2
    assert r["port_out"].shape == r["jax_out"].shape == (2, k, 24, 32, 1)
    np.testing.assert_allclose(r["port_out"], r["jax_out"], rtol=RTOL, atol=ATOL)


def test_nested_sets_match_jax(head_run):
    r = head_run
    if r["utype"] == "softmax":
        # the port's sets of the JAX logits, pixel by pixel under the rule;
        # the port's own logits give the same bins where the cdf is clear
        out = torch.from_numpy(np.moveaxis(r["jax_out"], -1, 2).copy())
        got = [_nhwc(a) for a in tsets.interval_params(out, "softmax")]
        off = _softmax_rule(got, r["jax_params"], r["jax_cdf"], 50)
        for g, w in zip(r["port_sets"], r["jax_sets"]):
            np.testing.assert_allclose(g[~off], w[~off], rtol=RTOL, atol=ATOL)
        return
    for g, w in zip(r["port_sets"], r["jax_sets"]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_train_step_in_f64_matches_jax(head_run):
    loss, got, stats = head_run["port64"]
    want_loss, want = head_run["jax64"]
    # the heads emit float32 on both sides (the JAX heads cast), so the
    # softmax loss's log-softmax runs in f32 in the f64 step: f32's bar
    np.testing.assert_allclose(loss, want_loss,
                               rtol=1e-6 if head_run["utype"] == "softmax" else 1e-12)
    assert len(got) == 74 + (1 if head_run["utype"] == "softmax" else 2) * 2
    for n, g in got.items():
        if re.search(r"double_conv\.[03]\.bias$", n):  # BatchNorm follows
            assert (g - want[n]).norm() <= 1e-9 * want[n[:-4] + "weight"].norm(), n
        else:
            assert (g - want[n]).norm() <= 1e-6 * want[n].norm(), n
    for n, s in stats.items():
        assert (s - want[n]).norm() <= 1e-9 * want[n].norm(), n


def test_softmax_interval_params_follow_the_rule_at_many_bins():
    """S = 1000 at 64² puts some pixels' cdf within rounding of a
    threshold, and some of them land one bin apart."""
    out = np.random.RandomState(4).randn(2, 1000, 64, 64, 1).astype(np.float32)
    want = [np.asarray(a) for a in jsets.interval_params(jnp.asarray(out), "softmax")]
    got = [_nhwc(a) for a in tsets.interval_params(
        torch.from_numpy(np.moveaxis(out, -1, 2).copy()), "softmax")]
    cdf = np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(out), axis=1), axis=1))
    assert _softmax_rule(got, want, cdf, 1000).any()
    for a in got[1:]:
        assert (a >= 0).all()


def test_softmax_interval_params_carry_no_gradient():
    out = torch.randn(2, 7, 1, 4, 4, requires_grad=True)
    assert not any(t.requires_grad for t in tsets.interval_params(out, "softmax"))


# ------------------------------------------------------------------ router


def _stand_in_output(stack, x, utype: str, centres):
    """(B, K, ...) head output from a (B, ...) map by correctly rounded
    operations; ``stack`` is jnp.stack or torch.stack. Gaussian variances
    are 0 where x < 0 (zero slopes), residual magnitudes are positive, the
    softmax logits peak at the bin centre nearest x."""
    if utype == "gaussian":
        return stack([x, (x + abs(x)) * 0.15], 1)
    if utype.startswith("residual"):
        return stack([x, abs(x) * 0.2 + 0.05], 1)
    d = x[:, None] - centres
    return -(d * d) * 2.0


class _JaxStandIn(fnn.Module):
    utype: str
    num_softmax: int

    @fnn.compact
    def __call__(self, x, train=False):
        anchor = self.param("anchor", fnn.initializers.zeros, ())
        self.variable("batch_stats", "unused", jnp.zeros, ())
        centres = jnp.asarray(np.linspace(-2, 2, self.num_softmax, dtype=np.float32)
                              ).reshape(1, -1, 1, 1, 1)
        return _stand_in_output(jnp.stack, x, self.utype, centres) + 0.0 * anchor


class _TorchStandIn(nn.Module):
    def __init__(self, utype: str, num_softmax: int):
        super().__init__()
        self.utype = utype
        self.anchor = nn.Parameter(torch.zeros(()))
        self.register_buffer("centres", torch.from_numpy(
            np.linspace(-2, 2, num_softmax, dtype=np.float32)).reshape(1, -1, 1, 1, 1))

    def forward(self, x):
        return _stand_in_output(torch.stack, x, self.utype, self.centres) + 0.0 * self.anchor


def _router_config(utype: str) -> dict:
    (cfg,) = load_config(ROUTER_CONFIG)
    return dict(cfg, uncertainty_type=utype, num_examples=16, image_size=32,
                data_split_percentages=[0.5, 0.25, 0.25, 0.0], num_lambdas=20, epochs=1,
                batch_size=4, checkpoint_every=1, validate_every=1, num_validation_images=2)


@pytest.fixture(scope="module")
def routers(tmp_path_factory):
    """Both routers for each head, the model a stand-in on both sides."""
    root = tmp_path_factory.mktemp("head_routers")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrouter, "build_trunk", lambda cfg: None)
        mp.setattr(jrouter, "add_uncertainty", lambda trunk, cfg, rng, example_input:
                   jasm.UQState(model=(m := _JaxStandIn(cfg["uncertainty_type"],
                                                        cfg["num_softmax"])),
                                variables=m.init(rng, example_input), params=dict(cfg)))
        mp.setattr(trouter, "build_trunk", lambda cfg: None)
        mp.setattr(trouter, "add_uncertainty", lambda trunk, cfg, generator, device:
                   tasm.UQState(model=_TorchStandIn(cfg["uncertainty_type"],
                                                    cfg["num_softmax"]).to(device),
                                params=dict(cfg)))
        for utype in HEADS:
            cfgs = {}
            for side in ("jax", "port"):
                cfgs[side] = dict(_router_config(utype),
                                  output_dir=str(root / utype / side / "out"),
                                  checkpoint_dir=str(root / utype / side / "ckpt"))
            jrouter.run_experiment(cfgs["jax"], mesh=data_parallel_mesh(1))
            path = root / utype / "port.yml"
            path.write_text(yaml.safe_dump(cfgs["port"]))
            assert trouter.main(["--config", str(path), "--device", "cpu"]) == 0
            runs[utype] = cfgs
    return runs


def _listing(cfg) -> list[str]:
    names = []
    for key in ("output_dir", "checkpoint_dir"):
        for dirpath, _, files in os.walk(cfg[key]):
            rel = os.path.relpath(dirpath, cfg[key])
            names += [os.path.normpath(os.path.join(key, rel, f)) for f in files]
    return sorted(n.replace(".msgpack", ".pt") for n in names)


def _load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("utype", HEADS)
def test_routers_write_the_same_artifacts_and_keys(routers, utype):
    jcfg, tcfg = routers[utype]["jax"], routers[utype]["port"]
    assert _listing(tcfg) == _listing(jcfg)
    assert f"checkpoint_dir/CP_calibrated_synthetic_{utype}_4_0.001_standard_min-max.pt" in \
        _listing(tcfg)
    got = _load(trouter.results_filename(tcfg))
    want = _load(jrouter.results_filename(jcfg))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w) or (np.isscalar(g) and np.isscalar(w)), key
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, key
        if isinstance(w, list):
            assert [np.shape(a) for a in g] == [np.shape(a) for a in w], key


@pytest.mark.parametrize("utype", HEADS)
def test_routers_lambda_hat_and_table_match_on_shared_outputs(routers, utype):
    jcfg, tcfg = routers[utype]["jax"], routers[utype]["port"]
    got = _load(trouter.loss_table_filename(tcfg))
    want = _load(jrouter.loss_table_filename(jcfg))
    assert got.shape == want.shape == (8, 20) and got.dtype == want.dtype
    assert 0.0 < want.mean() < 1.0
    lhat, want_lhat = (_load(f(c))["lhat"] for f, c in ((trouter.results_filename, tcfg),
                                                         (jrouter.results_filename, jcfg)))
    if utype != "softmax":
        np.testing.assert_array_equal(got, want)
        assert lhat == want_lhat
        return
    # the rule: a row may differ only for an image that holds a pixel near
    # a threshold; λ̂ is equal when the calibration rows are
    near = _near_threshold_images(jcfg)
    differ = (got != want).any(axis=1)
    assert not (differ & ~near).any()
    if not differ[: len(near) // 2].any():
        assert lhat == want_lhat


def _near_threshold_images(cfg: dict) -> np.ndarray:
    """Per row of the router's table (the calibration images, then the
    validation ones): whether the image holds a pixel near a threshold
    (``_near_threshold``) under the JAX stand-in."""
    _, calib, val, _ = jrouter.split_dataset(jrouter.build_dataset(cfg), cfg,
                                             np.random.RandomState(cfg["seed"]))
    x = np.stack([np.asarray(d[i][0]) for d in (calib, val) for i in range(len(d))])
    model = _JaxStandIn("softmax", cfg["num_softmax"])
    out = model.apply(model.init(jax.random.key(0), jnp.asarray(x)), jnp.asarray(x))
    cdf = np.asarray(jnp.cumsum(jax.nn.softmax(out, axis=1), axis=1))
    return _near_threshold(cdf).reshape(len(cdf), -1).any(axis=1)
