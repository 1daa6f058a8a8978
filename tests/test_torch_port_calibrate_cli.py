"""Port parity: the calibrate-only CLI and the sweep runner.

At the JAX CLI test's config (``tests/test_calibrate_cli.py``: synthetic,
24 images of 32x32, 40 λ), the same JAX weights go to the JAX CLI as a
``.msgpack`` training checkpoint and to the port's as a ``.pt`` one
(``interop/from_jax.state_dict_from_jax``), and both CLIs run on the CPU:

- through the two forwards: λ̂ within one grid step and at most 0.1% of
  the table cells different, the rule of
  ``tests/test_torch_port_calibration.py`` (a forward difference of ~1e-7
  can move a pixel across a grid λ);
- on one shared loss table (``compute_loss_table`` monkeypatched in both
  packages): identical λ̂ and identical tables;
- ``--calib-fraction 0.5 --seed 3`` calibrates on the same indices;
- the summary has the JAX keys, and the calibrated checkpoint the JAX stem;
- a calibrated checkpoint calibrates again to the same λ̂ and table.

The sweep runner runs two synthetic grid points at 16x16 in router
subprocesses on ``--device cpu`` and writes both results pickles; a grid
with a failing point exits 1 and names it.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from im2im_uq_tpu.calibration import rcps as jrcps
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.scripts import calibrate as jcal
from im2im_uq_tpu.training import checkpoint as jckpt
from im2im_uq_tpu.training.train import TrainState

from im2im_uq_tpu_torch.calibration import rcps as trcps
from im2im_uq_tpu_torch.interop.from_jax import state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.scripts import calibrate as tcal
from im2im_uq_tpu_torch.scripts import sweep as tsweep
from im2im_uq_tpu_torch.training import checkpoint as tckpt
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
# tests/test_calibrate_cli.py's config, α and δ as there
CFG = {
    "dataset": "synthetic",
    "num_examples": 24,
    "image_size": 32,
    "model": "UNet",
    "uncertainty_type": "quantiles",
    "alpha": 0.3,
    "delta": 0.3,
    "num_lambdas": 40,
    "minimum_lambda": 0.0,
    "maximum_lambda": 6.0,
    "batch_size": 8,
    "lr": 1e-3,
    "epochs": 1,
    "input_normalization": "standard",
    "output_normalization": "min-max",
    "q_lo": 0.05,
    "q_hi": 0.95,
    "q_lo_weight": 1.0,
    "q_hi_weight": 1.0,
    "mse_weight": 1.0,
    "num_inputs": 1,
}
DLAM = 6.0 / 39


def _write_sweep(path: Path, params: dict) -> Path:
    path.write_text(yaml.safe_dump({"parameters": {
        k: ({"values": v} if isinstance(v, tuple) else {"value": v}) for k, v in params.items()
    }}))
    return path


def _run(cli, root: Path, out: str, ckpt: str, *extra: str) -> dict:
    assert cli.main(["--config", str(root / "config.yml"), "--checkpoint", ckpt,
                     "--output-dir", str(root / out), *extra]) == 0
    summary = json.loads((root / out / "calibration_summary.json").read_text())
    with np.load(root / out / "calibration_loss_table.npz") as z:
        summary["_table"] = z["loss_table"]
    return summary


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One JAX init as a JAX .msgpack and a port .pt training checkpoint,
    and the two CLIs' runs on them."""
    root = tmp_path_factory.mktemp("calib_cli_port")
    jstate = jasm.add_uncertainty(
        jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
        example_input=jnp.zeros((1, 32, 32, 1)),
    )
    tx = optax.adam(CFG["lr"])
    ts = TrainState(
        params=jstate.variables["params"], batch_stats=jstate.variables["batch_stats"],
        opt_state=tx.init(jstate.variables["params"]), step=jnp.zeros((), jnp.int32),
    )
    jpath = jckpt.checkpoint_path(str(root / "jax_ckpt"), 1, CFG)
    os.makedirs(os.path.dirname(jpath))
    jckpt.save_checkpoint(jpath, ts, None, 1)

    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    tstate = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    tstate.model.load_state_dict(state_dict_from_jax(variables, "UNet", "quantiles"))
    tpath = tckpt.checkpoint_path(str(root / "port_ckpt"), 1, CFG)
    tckpt.save_checkpoint(tpath, tstate.model, torch.optim.Adam(tstate.model.parameters()),
                          None, 1)
    _write_sweep(root / "config.yml", CFG)
    return {
        "root": root, "jpath": jpath, "tpath": tpath,
        "jax": _run(jcal, root, "jax_out", jpath),
        "port": _run(tcal, root, "port_out", tpath, "--device", "cpu"),
    }


def test_lhat_within_one_grid_step_and_tables_agree(env):
    j, t = env["jax"], env["port"]
    assert t["_table"].shape == j["_table"].shape == (24, 40)
    assert 0.0 < j["lhat"] < 6.0  # inside the grid, not at its top
    assert abs(t["lhat"] - j["lhat"]) <= DLAM + 1e-12
    assert (t["_table"] != j["_table"]).mean() <= 1e-3


def test_summary_keys_and_calibrated_stem_match_jax(env):
    j, t = env["jax"], env["port"]
    assert sorted(t) == sorted(j)
    for key in ("alpha", "delta", "num_calibration_examples", "num_lambdas"):
        assert t[key] == j[key], key
    assert Path(t["checkpoint"]).stem == Path(j["checkpoint"]).stem
    assert Path(t["checkpoint"]).suffix == ".pt"
    assert Path(t["loss_table"]).name == Path(j["loss_table"]).name
    assert isinstance(t["calibration_seconds"], float)


def test_shared_table_gives_identical_lhat(env, monkeypatch):
    table = np.random.RandomState(0).uniform(0.0, 0.6, (24, 40)).astype(np.float32)
    table = np.sort(table, axis=1)[:, ::-1].copy()  # non-increasing in λ
    monkeypatch.setattr(jrcps, "compute_loss_table", lambda *a, **k: table.copy())
    monkeypatch.setattr(trcps, "compute_loss_table", lambda *a, **k: table.copy())
    root = env["root"]
    j = _run(jcal, root, "jax_shared", env["jpath"])
    t = _run(tcal, root, "port_shared", env["tpath"], "--device", "cpu")
    assert 0.0 < t["lhat"] < 6.0
    assert t["lhat"] == j["lhat"]
    np.testing.assert_array_equal(t["_table"], j["_table"])


def test_calib_fraction_draws_the_jax_subset(env, monkeypatch):
    seen = {}

    def capture(side):
        def calibrate_model(state, dataset, config, **kw):
            seen[side] = list(dataset.indices)
            return state.set_lhat(1.0), np.zeros((len(dataset), 40), np.float32)
        return calibrate_model

    monkeypatch.setattr(jrcps, "calibrate_model", capture("jax"))
    monkeypatch.setattr(tcal, "calibrate_model", capture("port"))
    args = ("--calib-fraction", "0.5", "--seed", "3")
    j = _run(jcal, env["root"], "jax_frac", env["jpath"], *args)
    t = _run(tcal, env["root"], "port_frac", env["tpath"], *args, "--device", "cpu")
    assert len(seen["port"]) == 12 and j["num_calibration_examples"] == 12
    assert [int(i) for i in seen["port"]] == [int(i) for i in seen["jax"]]
    assert t["num_calibration_examples"] == 12


def test_calibrated_checkpoint_calibrates_again(env):
    again = _run(tcal, env["root"], "port_again", env["port"]["checkpoint"], "--device", "cpu")
    assert again["lhat"] == env["port"]["lhat"]
    np.testing.assert_array_equal(again["_table"], env["port"]["_table"])


SWEEP = dict(
    CFG, num_examples=8, image_size=16, data_split_percentages=[0.5, 0.25, 0.25, 0.0],
    batch_size=4, num_lambdas=10, validate_every=1, checkpoint_every=1,
    num_validation_images=1,
)


def _sweep_env(tmp_path, monkeypatch, **params) -> Path:
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    return _write_sweep(tmp_path / "sweep.yml", dict(SWEEP, output_dir=str(tmp_path / "out"),
                                                     **params))


def test_sweep_runs_every_point_in_a_router_subprocess(tmp_path, monkeypatch, capsys):
    cfg = _sweep_env(tmp_path, monkeypatch, lr=(1e-3, 2e-3))
    tsweep.main(["--config", str(cfg), "--device", "cpu", "--jobs", "2"])
    assert "[sweep] all points complete" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "out").glob("results_*.pkl"))
    assert names == [f"results_synthetic_quantiles_4_{lr}_standard_min-max.pkl"
                     for lr in (0.001, 0.002)]


def test_sweep_reports_a_failed_point(tmp_path, monkeypatch, capsys):
    cfg = _sweep_env(tmp_path, monkeypatch, uncertainty_type=("quantiles", "bogus"))
    with pytest.raises(SystemExit) as exit_:
        tsweep.main(["--config", str(cfg), "--device", "cpu", "--jobs", "2"])
    assert exit_.value.code == 1
    assert "[sweep] FAILED points: [1]" in capsys.readouterr().out
    assert len(list((tmp_path / "out").glob("results_*.pkl"))) == 1
