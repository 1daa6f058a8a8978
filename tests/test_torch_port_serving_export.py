"""Port parity: the serving artifact (``scripts/export_serving.py``), the
serving CLI (``scripts/infer.py``) and the rest of the ``UQState`` API,
against the JAX package.

- The artifact gives the live portable model's nested sets (the same model
  under the ``"xla"`` backends, ``export_serving.portable_state``) bit for
  bit on the CPU, for all seven heads, bf16 ``quantiles`` and WNet, at
  batch 2, 32x32: the same ATen ops on the same values.
- From the same weights, the port's artifact gives the JAX artifact's sets
  (exported on the CPU) within rtol 1e-4 / atol 1e-5, NCHW against NHWC
  (f32 forwards of two libraries), and its metadata has the JAX keys with
  ``torch_version`` for ``jax_version``.
- The artifact serves through ``predict_intervals`` with a ragged tail; a
  baked λ refuses another λ and a mesh; export refuses a model without λ̂
  and a data-parallel artifact whose batch does not divide over its
  devices (the data-parallel artifact itself: ``test_torch_port_multigpu.py``);
  the platform guard refuses an artifact exported for ``cuda`` alone on the
  CPU.
- ``export_serving.main`` then ``infer.main --artifact`` write the JAX
  CLI's file names and summary keys, and the intervals of
  ``infer.main --config --checkpoint`` on the portable config bit for bit;
  ``--batch-size`` warns only when it differs from the artifact's, and a
  conflicting ``--lam`` or both ways of naming a model are refused, as in
  the JAX CLI.
- ``--data-parallel`` and ``--spatial`` change nothing where one device of
  ``--device``'s type is visible (the JAX CLI builds its mesh only over
  more than one device): bit for bit the run without the flag. Both
  together are refused with the JAX CLI's message.
- ``UQState.loss_fn`` / ``heads.head_loss_fn`` give the JAX head losses
  (rtol 1e-5: f32 means in another order) and ``nested_sets_from_output``
  resolves λ as ``nested_sets`` does.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.scripts import export_serving as jexport
from im2im_uq_tpu.scripts import infer as jinfer
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.scripts import export_serving as texport
from im2im_uq_tpu_torch.scripts import infer as tinfer
from im2im_uq_tpu_torch.training import checkpoint as tckpt
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(
    DEFAULTS, dataset="synthetic", model="UNet", uncertainty_type="quantiles",
    batch_size=4, lr=1e-3,
)
LHAT = 2.25
HEADS = ["quantiles", "quantiles_l1", "inn", "gaussian", "residual_magnitude",
         "residual_magnitude_l1", "softmax"]
CASES = {
    **{h: {"uncertainty_type": h} for h in HEADS},
    "quantiles_bf16": {"compute_dtype": "bfloat16"},
    "wnet": {"model": "WNet", "num_inputs": 2},
}


def _port_state(cfg: dict, seed: int = 0) -> tasm.UQState:
    return tasm.add_uncertainty(
        tasm.build_trunk(cfg), cfg, generator=torch.Generator().manual_seed(seed), device="cpu",
    )


def _nchw(x: np.ndarray) -> torch.Tensor:
    return tasm.nchw_from_nhwc(x, "cpu")


@pytest.fixture(scope="module")
def port_env(tmp_path_factory):
    """A calibrated port checkpoint of seeded weights, its config file, the
    same model's config under the "xla" backends, its artifact at batch 4,
    32x32, and 5 inputs."""
    root = tmp_path_factory.mktemp("port_serving")
    state = _port_state(CFG).set_lhat(LHAT)
    ckpt = tckpt.save_calibrated_checkpoint(state, CFG, str(root / "ckpt"))
    cfg_yaml = root / "config.yml"
    cfg_yaml.write_text(yaml.safe_dump(CFG))
    portable_yaml = root / "portable.yml"
    portable_yaml.write_text(yaml.safe_dump(dict(
        CFG, conv_backend="xla", pool_backend="xla", resize_backend="xla")))
    art = root / "model.uq.pt2"
    meta = texport.export_serving_artifact(state, str(art), batch_size=4, height=32, width=32)
    np.save(root / "vol.npy", np.random.RandomState(2).randn(5, 32, 32, 1).astype(np.float32))
    return {"root": root, "state": state, "ckpt": ckpt, "cfg": cfg_yaml,
            "portable": portable_yaml, "art": art, "meta": meta}


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """The JAX model (randomised BN statistics) and its artifact at batch 4,
    32x32 on the CPU; the port's model on its weights and the port's
    artifact."""
    root = tmp_path_factory.mktemp("jax_serving")
    jstate = jasm.add_uncertainty(
        jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
        example_input=jnp.zeros((1, 32, 32, 1)),
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    rng = np.random.RandomState(1)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0.0, 0.1, a.shape) if jax.tree_util.keystr(path).endswith(
            "['mean']") else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        variables["batch_stats"])
    jstate = jstate.replace(variables=jax.tree_util.tree_map(jnp.asarray, variables))
    jart = root / "jax.uq.npz"
    jmeta = jexport.export_serving_artifact(
        jstate, str(jart), batch_size=4, height=32, width=32, lam=LHAT, platforms=("cpu",))
    tstate = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    tart = root / "port.uq.pt2"
    tmeta = texport.export_serving_artifact(
        tstate, str(tart), batch_size=4, height=32, width=32, lam=LHAT, platforms=("cpu",))
    return {"root": root, "jart": jart, "jmeta": jmeta, "tart": tart, "tmeta": tmeta}


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_the_live_portable_model(case, tmp_path):
    cfg = dict(CFG, **CASES[case])
    state = _port_state(cfg, seed=3).set_lhat(LHAT)
    meta = texport.export_serving_artifact(
        state, str(tmp_path / "a.pt2"), batch_size=2, height=32, width=32)
    assert meta["program"] == "portable_xla" and meta["lam"] == LHAT
    assert meta["channels"] == cfg["num_inputs"]
    assert meta["compute_dtype"] == cfg.get("compute_dtype", "float32")
    loaded = texport.load_serving_artifact(str(tmp_path / "a.pt2"), "cpu")
    assert loaded.uncertainty_type == cfg["uncertainty_type"] and loaded.batch_size == 2
    x = _nchw(np.random.RandomState(4).randn(2, 32, 32, cfg["num_inputs"]).astype(np.float32))
    got = loaded.nested_sets(x)
    want = texport.portable_state(state).nested_sets(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 1, 32, 32)
        assert torch.equal(g, w)


def test_artifact_matches_the_jax_artifact(jax_pair):
    x = np.random.RandomState(0).randn(4, 32, 32, 1).astype(np.float32)
    want = jexport.load_serving_artifact(str(jax_pair["jart"])).nested_sets(x)
    got = texport.load_serving_artifact(str(jax_pair["tart"]), "cpu").nested_sets(_nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_metadata_has_the_jax_keys(jax_pair):
    jmeta, tmeta = jax_pair["jmeta"], jax_pair["tmeta"]
    assert sorted(tmeta) == sorted(k.replace("jax_", "torch_") for k in jmeta)
    assert tmeta["torch_version"] == torch.__version__
    for key in ("artifact_version", "batch_size", "height", "width", "channels", "lam",
                "uncertainty_type", "model", "compute_dtype", "platforms", "n_devices",
                "param_count", "program"):
        assert tmeta[key] == jmeta[key], key


def test_artifact_serves_through_predict_intervals(port_env):
    loaded = texport.load_serving_artifact(str(port_env["art"]), "cpu")
    x = np.random.RandomState(1).randn(6, 32, 32, 1).astype(np.float32)
    got = tinfer.predict_intervals(loaded, x, batch_size=4)
    want = tinfer.predict_intervals(texport.portable_state(port_env["state"]), x, batch_size=4)
    for key in ("lower", "prediction", "upper"):
        assert got[key].shape == (6, 32, 32, 1)
        np.testing.assert_array_equal(got[key], want[key])


def test_lambda_and_sharding_are_baked(port_env):
    loaded = texport.load_serving_artifact(str(port_env["art"]), "cpu")
    x = torch.zeros((4, 1, 32, 32))
    loaded.nested_sets(x, lam=LHAT)  # the baked λ is fine
    with pytest.raises(ValueError, match="baked"):
        loaded.nested_sets(x, lam=1.0)
    with pytest.raises(ValueError, match="bake"):
        loaded.nested_sets(x, mesh=object())


def test_export_refusals(port_env, tmp_path):
    state = port_env["state"]
    kw = dict(batch_size=4, height=32, width=32)
    with pytest.raises(ValueError, match="λ̂"):
        texport.export_serving_artifact(state.replace(lhat=None), str(tmp_path / "a"), **kw)
    with pytest.raises(ValueError, match="must divide by n_devices 3"):
        texport.export_serving_artifact(state, str(tmp_path / "b"), n_devices=3, **kw)
    with pytest.raises(ValueError, match="n_devices"):
        texport.export_serving_artifact(state, str(tmp_path / "c"), n_devices=0, **kw)
    with pytest.raises(ValueError, match="platforms"):
        texport.export_serving_artifact(state, str(tmp_path / "d"), platforms=("tpu",), **kw)


def test_platform_guard(port_env, tmp_path):
    art = tmp_path / "cuda_only.uq.pt2"
    texport.export_serving_artifact(port_env["state"], str(art), batch_size=4, height=32,
                                    width=32, platforms=("cuda",))
    with pytest.raises(ValueError, match="--platforms cpu"):
        texport.load_serving_artifact(str(art), "cpu")


def test_cli_export_then_infer_artifact(port_env, jax_pair, tmp_path, capsys):
    root = port_env["root"]
    art = tmp_path / "cli.uq.pt2"
    assert texport.main(["--config", str(port_env["cfg"]), "--checkpoint", port_env["ckpt"],
                         "--output", str(art), "--batch-size", "4", "--height", "32",
                         "--width", "32", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(printed) == sorted(list(port_env["meta"]) + ["artifact_mb"])
    assert printed["platforms"] == ["cpu", "cuda"] and printed["artifact_mb"] > 0

    vol = ["--input", str(root / "vol.npy")]
    assert tinfer.main(["--artifact", str(art), *vol, "--output", str(tmp_path / "art"),
                        "--device", "cpu"]) == 0
    assert tinfer.main(["--config", str(port_env["portable"]), "--checkpoint",
                        port_env["ckpt"], *vol, "--output", str(tmp_path / "live"),
                        "--batch-size", "4", "--device", "cpu"]) == 0
    assert jinfer.main(["--artifact", str(jax_pair["jart"]), *vol,
                        "--output", str(tmp_path / "jax")]) == 0
    names = sorted(p.name for p in (tmp_path / "art").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    with np.load(tmp_path / "art" / "vol_intervals.npz") as za, \
            np.load(tmp_path / "live" / "vol_intervals.npz") as zl:
        assert sorted(za.files) == ["lam", "lower", "prediction", "upper"]
        assert float(za["lam"]) == LHAT
        for key in ("lower", "prediction", "upper"):
            np.testing.assert_array_equal(za[key], zl[key])
    st, sj = (json.loads((tmp_path / d / "inference_summary.json").read_text())
              for d in ("art", "jax"))
    assert sorted(st) == sorted(sj)
    assert (st["images"], st["lam"], st["uncertainty_type"]) == (5, LHAT, "quantiles")


def test_cli_argument_validation(port_env, tmp_path):
    x = tmp_path / "x.npy"
    np.save(x, np.zeros((1, 32, 32, 1), np.float32))
    base = ["--input", str(x), "--output", str(tmp_path / "o"), "--device", "cpu"]
    art = str(port_env["art"])
    with pytest.raises(SystemExit, match="either"):
        tinfer.main(["--artifact", art, "--config", str(port_env["cfg"])] + base)
    with pytest.raises(SystemExit, match="either"):
        tinfer.main(base)
    with pytest.raises(SystemExit, match="baked"):
        tinfer.main(["--artifact", art, "--lam", "1.0"] + base)


def test_cli_artifact_batch_size_warning_sentinel(port_env, tmp_path, capsys):
    x = tmp_path / "w.npy"
    np.save(x, np.random.RandomState(3).randn(2, 32, 32, 1).astype(np.float32))
    base = ["--artifact", str(port_env["art"]), "--input", str(x), "--device", "cpu"]
    # an abbreviation of the flag, against the artifact's batch of 4
    assert tinfer.main(base + ["--output", str(tmp_path / "o1"), "--batch=64"]) == 0
    assert "ignored" in capsys.readouterr().err
    assert tinfer.main(base + ["--output", str(tmp_path / "o2")]) == 0
    assert "ignored" not in capsys.readouterr().err
    assert tinfer.main(base + ["--output", str(tmp_path / "o3"), "--batch-size", "4"]) == 0
    assert "ignored" not in capsys.readouterr().err


def _serve(env, out: str, *extra: str) -> dict:
    root = env["root"]
    rc = tinfer.main(["--config", str(env["cfg"]), "--checkpoint", env["ckpt"],
                      "--input", str(root / "vol.npy"), "--output", str(root / out),
                      "--batch-size", "4", "--device", "cpu", *extra])
    assert rc == 0
    with np.load(root / out / "vol_intervals.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("flag", ["--data-parallel", "--spatial"])
def test_sharding_flags_change_nothing_on_one_device(port_env, flag):
    want = _serve(port_env, "plain")
    got = _serve(port_env, flag.strip("-"), flag)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_sharding_flags_are_mutually_exclusive(port_env, tmp_path):
    both = ["--data-parallel", "--spatial", "--config", str(port_env["cfg"]), "--checkpoint",
            port_env["ckpt"], "--input", str(tmp_path), "--output", str(tmp_path)]
    with pytest.raises(SystemExit, match="mutually exclusive") as jerr:
        jinfer.main(both)
    with pytest.raises(SystemExit, match="mutually exclusive") as terr:
        tinfer.main(both + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value)


def _head_case(utype: str, rng: np.random.RandomState):
    """A head output (B, K, H, W, 1) and targets in [0, 1], both layouts."""
    k = {"gaussian": 2, "residual_magnitude": 2, "residual_magnitude_l1": 2,
         "softmax": CFG["num_softmax"]}.get(utype, 3)
    pred = rng.randn(2, k, 8, 8, 1).astype(np.float32)
    if utype == "gaussian":
        pred[:, 1] = np.abs(pred[:, 1]) + 0.1
    target = rng.uniform(0.0, 1.0, (2, 8, 8, 1)).astype(np.float32)
    return (jnp.asarray(pred), jnp.asarray(target),
            torch.from_numpy(pred.transpose(0, 1, 4, 2, 3).copy()),
            torch.from_numpy(target.transpose(0, 3, 1, 2).copy()))


@pytest.mark.parametrize("utype", HEADS)
def test_loss_fn_and_nested_sets_from_output_match_jax(utype):
    cfg = dict(CFG, uncertainty_type=utype)
    jpred, jtarget, tpred, ttarget = _head_case(utype, np.random.RandomState(5))
    want = float(jheads.head_loss_fn(utype)(jpred, jtarget, cfg))
    state = tasm.UQState(model=None, params=cfg)
    got = state.loss_fn(tpred, ttarget)
    assert got.shape == () and got.item() == pytest.approx(want, rel=1e-5)
    assert theads.head_loss_fn(utype)(tpred, ttarget, cfg).item() == got.item()

    jstate = jasm.UQState(model=None, variables={}, params=cfg, lhat=1.5)
    jsets = jstate.nested_sets_from_output(jpred)
    tsets = state.set_lhat(1.5).nested_sets_from_output(tpred)
    explicit = state.nested_sets_from_output(tpred, 1.5)
    assert all(torch.equal(a, b) for a, b in zip(tsets, explicit))
    for t, j in zip(tsets, jsets):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="lambda"):
        state.nested_sets_from_output(tpred)


def test_head_loss_fn_refuses_an_unknown_type():
    with pytest.raises(NotImplementedError, match="unknown uncertainty_type"):
        theads.head_loss_fn("bogus")
    with pytest.raises(NotImplementedError, match="unknown uncertainty_type"):
        jheads.head_loss_fn("bogus")
