"""Port parity: calibration, checkpoints and serving against the JAX package.

- ``calibrate_model`` on one shared loss table (``compute_loss_table``
  monkeypatched in both packages): identical λ̂ and identical tables, with
  the columns below the stop zeroed, for the hb and wsr bounds. One table
  has R̂ exactly 0 in its top columns, where HB(0) = 1 stops the scan.
- ``evaluate_from_loss_table(_fast)``: trial-for-trial equal results from
  the same RandomState.
- End to end through the two forwards (the JAX model's weights loaded into
  the port) on 16 synthetic 32x32 images: λ̂ within one grid step and at
  most 0.1% of the table cells different (a forward difference of ~1e-7
  can move a pixel across a grid λ).
- ``predict_intervals`` and ``infer.main`` against the JAX package's, with
  rtol 1e-4 / atol 1e-5 on the interval values (f32 forwards on the CPU).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from im2im_uq_tpu.calibration import rcps as jrcps
from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.scripts import infer as jinfer
from im2im_uq_tpu.training import checkpoint as jckpt
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.calibration import rcps as trcps
from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.parallel import distributed as tdistributed
from im2im_uq_tpu_torch.scripts import infer as tinfer
from im2im_uq_tpu_torch.training import checkpoint as tckpt
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(
    DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
    dataset="synthetic", batch_size=8, lr=1e-3, alpha=0.1, delta=0.1,
    num_lambdas=100, minimum_lambda=0.0, maximum_lambda=6.0,
)


def _table(kind: str) -> np.ndarray:
    """(60, 100) fraction-missed table at the calibration grid λ − dλ."""
    rng = np.random.RandomState(0)
    grid = np.linspace(0.0, 6.0, 100)
    lam = (grid - (grid[1] - grid[0])).astype(np.float32)
    crit = rng.exponential(0.8, (60, 400)).astype(np.float32)
    if kind == "zero_top":  # every pixel covered above λ=4: R̂ exactly 0 there
        crit = np.minimum(crit, 4.0)
    if kind == "never_covered":  # 3% of pixels missed at every λ
        crit[:, :12] = np.inf
    return (crit[:, :, None] > lam[None, None, :]).mean(axis=1).astype(np.float32)


@pytest.mark.parametrize("bound", ["hb", "wsr"])
@pytest.mark.parametrize("kind", ["crossing", "zero_top", "never_covered"])
def test_lambda_hat_matches_jax_on_a_shared_table(monkeypatch, kind, bound):
    table = _table(kind)
    cfg = dict(CFG, bound=bound)
    monkeypatch.setattr(jrcps, "compute_loss_table", lambda *a, **k: table.copy())
    monkeypatch.setattr(trcps, "compute_loss_table", lambda *a, **k: table.copy())
    js, jt = jrcps.calibrate_model(
        jasm.UQState(model=None, variables={}, params=cfg), None, cfg, method="direct"
    )
    ts, tt = trcps.calibrate_model(
        tasm.UQState(model=None, params=cfg), None, cfg, method="direct"
    )
    assert ts.lhat == js.lhat
    np.testing.assert_array_equal(tt, jt)
    if kind == "zero_top" and bound == "hb":
        assert ts.lhat == 6.0  # HB(0) = 1 rejects the all-covered top column


def test_evaluators_match_jax_trial_for_trial():
    table = _table("crossing")
    for fn in ("evaluate_from_loss_table", "evaluate_from_loss_table_fast"):
        for seed in range(8):
            want = getattr(jrcps, fn)(table, 30, 0.1, 0.1, rng=np.random.RandomState(seed))
            got = getattr(trcps, fn)(table, 30, 0.1, 0.1, rng=np.random.RandomState(seed))
            assert got == want, (fn, seed)
    for n, delta in ((30, 0.1), (1000, 0.05), (5, 0.1)):
        assert trcps.hb_acceptance_threshold(n, delta) == jrcps.hb_acceptance_threshold(n, delta)


def test_default_table_method():
    assert trcps.default_table_method(CFG, torch.device("cpu")) == "direct"
    assert trcps.default_table_method(CFG, "cuda") == "pallas"
    assert trcps.default_table_method(dict(CFG, loss_table_method="fast"), "cuda") == "fast"


def _randomise_stats(stats, rng: np.random.RandomState):
    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def pair():
    """The JAX model (randomised BN statistics) and the port with its weights."""
    jstate = jasm.add_uncertainty(
        jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
        example_input=jnp.zeros((1, 32, 32, 1)),
    )
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    variables["batch_stats"] = _randomise_stats(
        variables["batch_stats"], np.random.RandomState(1)
    )
    jstate = jstate.replace(variables=jax.tree_util.tree_map(jnp.asarray, variables))
    tstate = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    return jstate, tstate


def test_calibration_end_to_end_matches_jax(pair):
    jstate, tstate = pair
    # α and the λ range put λ̂ inside the grid for this untrained model
    cfg = dict(CFG, alpha=0.4, maximum_lambda=20.0, num_lambdas=200)
    ds = SyntheticDataset(num_examples=16, image_size=32)
    js, jt = jrcps.calibrate_model(jstate, ds, cfg, method="direct")
    ts, tt = trcps.calibrate_model(tstate, ds, cfg)
    dlam = 20.0 / 199
    assert 0.0 < ts.lhat < 20.0
    assert abs(ts.lhat - js.lhat) <= dlam + 1e-12
    assert tt.shape == jt.shape == (16, 200)
    assert (tt != jt).mean() <= 1e-3


def test_checkpoint_key_and_round_trip(pair, tmp_path):
    _, tstate = pair
    cfg = dict(CFG, output_normalization="min-max.v2", epochs=3)
    assert tckpt.checkpoint_key(cfg) == jckpt.checkpoint_key(cfg)
    path = tckpt.save_calibrated_checkpoint(tstate.set_lhat(1.25), cfg, str(tmp_path))
    assert path.endswith(f"CP_calibrated_{jckpt.checkpoint_key(cfg)}.pt")
    fresh = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    assert tckpt.load_calibrated_checkpoint(path, fresh.model) == (1.25, 3)
    a, b = tstate.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_predict_intervals_matches_jax(pair):
    jstate, tstate = pair
    inputs = np.random.RandomState(5).randn(5, 32, 32, 1).astype(np.float32)
    want = jinfer.predict_intervals(jstate.set_lhat(1.5), inputs, batch_size=2)
    got = tinfer.predict_intervals(tstate.set_lhat(1.5), inputs, batch_size=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape == inputs.shape
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def test_infer_main_writes_the_jax_outputs(pair, tmp_path):
    jstate, tstate = pair
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text(yaml.safe_dump(CFG))
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    rng = np.random.RandomState(6)
    np.save(inputs / "a.npy", rng.randn(3, 32, 32, 1).astype(np.float32))
    np.savez(inputs / "b.npz", x=rng.randn(32, 32, 1).astype(np.float32))
    jpath = jckpt.save_calibrated_checkpoint(jstate.set_lhat(2.0), CFG, str(tmp_path / "j"))
    tpath = tckpt.save_calibrated_checkpoint(tstate.set_lhat(2.0), CFG, str(tmp_path / "t"))
    common = ["--config", str(cfg_path), "--input", str(inputs), "--batch-size", "2"]
    assert jinfer.main(common + ["--checkpoint", jpath, "--output", str(tmp_path / "oj")]) == 0
    assert tinfer.main(common + ["--checkpoint", tpath, "--output", str(tmp_path / "ot"),
                                 "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "oj").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ot").iterdir())
    assert names == ["a_intervals.npz", "b_intervals.npz", "inference_summary.json"]
    for name in names[:2]:
        with np.load(tmp_path / "oj" / name) as zj, np.load(tmp_path / "ot" / name) as zt:
            assert sorted(zt.files) == sorted(zj.files) == ["lam", "lower", "prediction", "upper"]
            assert float(zt["lam"]) == float(zj["lam"]) == 2.0
            for k in ("lower", "prediction", "upper"):
                np.testing.assert_allclose(zt[k], zj[k], rtol=RTOL, atol=ATOL)
    sj, st = (json.loads((tmp_path / d / "inference_summary.json").read_text())
              for d in ("oj", "ot"))
    assert sorted(st) == sorted(sj)
    assert (st["images"], st["lam"], st["uncertainty_type"]) == (4, 2.0, "quantiles")


@pytest.mark.parametrize("flag", ["--artifact=x", "--data-parallel", "--spatial"])
def test_infer_main_rejects_unported_modes(flag, tmp_path, monkeypatch):
    """Over more than one CUDA device (one visible device leaves the flags
    without effect: ``test_torch_port_serving_export.py``) ``--artifact``
    with ``--data-parallel`` is refused with the JAX CLI's message (an
    artifact's sharding is fixed at export: ``export_serving --n-devices``);
    ``--data-parallel`` and ``--spatial`` start one rank per GPU running the
    same command (``test_torch_port_parallel.py`` and
    ``test_torch_port_multigpu.py`` run the ranks)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    spawned = []
    monkeypatch.setattr(tdistributed, "spawn_per_device",
                        lambda command, n, **kw: spawned.append((command, n)) or 0)
    model = (["--data-parallel"] if flag.startswith("--artifact")
             else ["--config", "c.yml", "--checkpoint", "c.pt"])
    argv = [flag, *model, "--input", str(tmp_path), "--output", str(tmp_path)]
    if flag != "--artifact=x":
        assert tinfer.main(argv) == 0
        assert spawned == [(["-m", "im2im_uq_tpu_torch.scripts.infer", *argv], 2)]
        return
    with pytest.raises(SystemExit, match="re-export with `export_serving --n-devices N`"):
        tinfer.main(argv)
    assert spawned == []
