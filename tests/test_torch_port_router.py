"""Port parity: the experiment router, the validation loss table, λ̂ and
the set metrics.

- Both routers run one small synthetic grid point (16 images of 32x32, one
  epoch, L=20; the JAX router on a one-device mesh). They write the same
  artifact names (the JAX training checkpoints end in ``.msgpack``, the
  port's in ``.pt``), results pickles with the same keys and value types,
  and loss tables of the same shape.
- On shared model outputs (a stand-in model whose output is the same
  elementwise function of the input on both sides, bit for bit):
  ``get_loss_table`` and ``calibrate_model`` give identical tables and
  identical λ̂, and ``eval_set_metrics`` with one ``RandomState`` gives the
  same metrics (every random draw in the same order); the sampled sizes
  agree to one f32 ulp.
- On a shared model (the JAX router's trained and calibrated weights loaded
  into the port) through the two UNet forwards: λ̂ equal, at most 0.5% of
  the table cells different (a forward difference of ~1e-7 can move a
  pixel across a grid λ), and the metrics within the same slack: risk to
  5e-3, the sampled sizes and the MSE to rtol 1e-4, Spearman to 1e-2.
"""

from __future__ import annotations

import os
import pickle
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from im2im_uq_tpu.calibration import metrics as jmetrics
from im2im_uq_tpu.calibration import rcps as jrcps
from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.parallel.mesh import data_parallel_mesh
from im2im_uq_tpu.scripts import router as jrouter
from im2im_uq_tpu.training import checkpoint as jckpt
from im2im_uq_tpu.training import evaluate as jevaluate
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.calibration import metrics as tmetrics
from im2im_uq_tpu_torch.calibration import rcps as trcps
from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.scripts import router as trouter
from im2im_uq_tpu_torch.training import evaluate as tevaluate
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CONFIG = dict(
    DEFAULTS, dataset="synthetic", num_examples=16, image_size=32,
    data_split_percentages=[0.5, 0.25, 0.25, 0.0], model="UNet",
    uncertainty_type="quantiles", num_lambdas=20, epochs=1, batch_size=4, lr=1e-3,
    checkpoint_every=1, validate_every=1, num_validation_images=2,
    resize_backend="xla", lane_pack=False,
)


def _dirs(root, side):
    return {"output_dir": str(root / side / "out"), "checkpoint_dir": str(root / side / "ckpt")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("routers")
    captured = {}
    save = jckpt.save_calibrated_checkpoint

    def capture(uq_state, config, checkpoint_dir):
        captured["state"] = uq_state
        return save(uq_state, config, checkpoint_dir)

    jcfg = dict(CONFIG, **_dirs(root, "jax"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "save_calibrated_checkpoint", capture)
        jrouter.run_experiment(jcfg, mesh=data_parallel_mesh(1))

    tcfg = dict(CONFIG, **_dirs(root, "port"))
    cfg_path = root / "port.yml"
    cfg_path.write_text(yaml.safe_dump(tcfg))
    assert trouter.main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    return {"jax": jcfg, "port": tcfg, "jax_state": captured["state"]}


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


def test_routers_write_the_same_artifacts(runs):
    port = _listing(runs["port"])
    assert port == _listing(runs["jax"])
    for name in (trouter.results_filename(runs["port"]), trouter.loss_table_filename(runs["port"])):
        assert os.path.relpath(name, runs["port"]["output_dir"]) in {
            os.path.relpath(p, "output_dir") for p in port
        }
    assert os.path.basename(trouter.results_filename(runs["port"])) == os.path.basename(
        jrouter.results_filename(runs["jax"]))
    assert os.path.basename(trouter.loss_table_filename(runs["port"])) == os.path.basename(
        jrouter.loss_table_filename(runs["jax"]))
    assert "ckpt/CP_calibrated_synthetic_quantiles_4_0.001_standard_min-max.pt".replace(
        "ckpt", "checkpoint_dir") in port


def test_results_pickles_have_the_same_keys_and_types(runs):
    got = _load(trouter.results_filename(runs["port"]))
    want = _load(jrouter.results_filename(runs["jax"]))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w) or (np.isscalar(g) and np.isscalar(w)), key
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, key
        if isinstance(w, list):
            assert [np.shape(a) for a in g] == [np.shape(a) for a in w], key
    grid = trcps.lambda_grid(runs["port"])
    assert got["lhat"] in grid


def test_loss_table_dumps_have_the_same_shape(runs):
    got = _load(trouter.loss_table_filename(runs["port"]))
    want = _load(jrouter.loss_table_filename(runs["jax"]))
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (8, 20)
    assert got.dtype == want.dtype
    assert np.isfinite(got).all() and 0.0 <= got.min() and got.max() <= 1.0


def test_rerun_skips_when_results_exist(runs, capsys):
    assert trouter.run_experiment(dict(runs["port"]), "cpu") is None
    assert "Results already precomputed" in capsys.readouterr().out


def test_device_flag_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trouter.main(["--config", "experiments/synthetic_test/config.yml", "--device", "cuda"])


def _raw_data(tmp_path, dataset: str) -> str:
    """Two small synthetic fastMRI volumes (k-space 48x40, recon 32x32, 8
    slices each), or eight 64x64 TEMCA tiles of 32x32 patches."""
    root = tmp_path / "data"
    root.mkdir()
    if dataset == "fastmri":
        from im2im_uq_tpu_torch.data.fastmri import write_synthetic_volume

        for i in range(2):
            write_synthetic_volume(str(root / f"v{i}.h5"), num_slices=8, enc_shape=(48, 40),
                                   recon_shape=(32, 32), seed=i)
        return str(root)
    import imageio

    rng = np.random.RandomState(12)
    for i in range(8):
        imageio.imwrite(root / f"tile{i}.png", rng.randint(1, 255, (64, 64), dtype=np.uint8))
    return str(root) + "/"


@pytest.mark.parametrize("dataset", ["fastmri", "temca"])
def test_on_device_transform_is_refused(runs, tmp_path, dataset, monkeypatch):
    """FastMRI and TEMCA, whose classes move their preprocessing onto the
    device under the flag, are no longer refused: the router trains on the
    raw items (k-space (B, 48, 40, 2) in the loader's layout, or NCHW uint8
    patches) through the dataset's hook, runs everything after training in
    image mode, and writes the JAX router's artifact names and a results
    pickle with the JAX router's keys and value types."""
    cfg = dict(CONFIG, dataset=dataset, data_path=_raw_data(tmp_path, dataset),
               on_device_transform=True, side_length=32, downsampling_factor=2, num_buffer=2,
               mask_info={"type": "equispaced", "center_fraction": [0.08], "acceleration": [4]},
               **_dirs(tmp_path, "port"))
    seen = []
    train_net = trouter.train_net

    def spy(*args, preprocess=None, preprocess_pair=None, **kw):
        assert (preprocess is None) != (preprocess_pair is None)
        hook = preprocess or preprocess_pair

        def recorded(*xs):
            seen.append([(tuple(x.shape), x.dtype) for x in xs])
            return hook(*xs)

        key = "preprocess" if preprocess is not None else "preprocess_pair"
        return train_net(*args, **{key: recorded}, **kw)

    monkeypatch.setattr(trouter, "train_net", spy)
    got = trouter.run_experiment(cfg, "cpu")
    want = (4, 48, 40, 2) if dataset == "fastmri" else (4, 1, 32, 32)
    dtype = torch.float32 if dataset == "fastmri" else torch.uint8
    assert seen and all(s[0] == (want, dtype) for s in seen)
    jax_names = {os.path.basename(f(dict(cfg, **_dirs(tmp_path, "jax"))))
                 for f in (jrouter.results_filename, jrouter.loss_table_filename)}
    assert jax_names <= set(os.listdir(cfg["output_dir"]))
    jax_checkpoints = [jckpt.calibrated_checkpoint_path("c", cfg),
                       jckpt.checkpoint_path("c", 1, cfg)]
    assert sorted(os.listdir(cfg["checkpoint_dir"])) == sorted(
        os.path.basename(p).replace(".msgpack", ".pt") for p in jax_checkpoints)
    saved = _load(trouter.results_filename(cfg))
    want_pickle = _load(jrouter.results_filename(runs["jax"]))
    assert sorted(saved) == sorted(got) == sorted(want_pickle)
    for key, w in want_pickle.items():
        assert type(saved[key]) is type(w) or (np.isscalar(saved[key]) and np.isscalar(w)), key
        if isinstance(w, np.ndarray):
            assert saved[key].dtype == w.dtype, key
    assert np.isfinite(saved["risk"]) and saved["lhat"] in trcps.lambda_grid(cfg)
    shutil.rmtree(tmp_path)  # the full-width model's checkpoints: about 280 MB


def test_on_device_transform_leaves_synthetic_unchanged(runs, tmp_path):
    """The synthetic dataset has no device preprocessing: with the flag the
    grid point runs as without it (the JAX router ignores it there too)."""
    cfg = dict(runs["port"], on_device_transform=True, **_dirs(tmp_path, "flag"))
    got = trouter.run_experiment(cfg, "cpu")
    want = _load(trouter.results_filename(runs["port"]))
    assert sorted(got) == sorted(want) == sorted(_load(trouter.results_filename(cfg)))
    assert got["lhat"] == want["lhat"]
    np.testing.assert_array_equal(_load(trouter.loss_table_filename(cfg)),
                                  _load(trouter.loss_table_filename(runs["port"])))


# ------------------------------------------------ shared model outputs


class _JaxStandIn(fnn.Module):
    """Head output (B, 3, H, W, C): an elementwise function of the input."""

    @fnn.compact
    def __call__(self, x, train=False):
        return jnp.stack([x - jnp.sqrt(jnp.abs(x) + 0.05), x, x + jnp.sqrt(jnp.abs(x) + 0.1)], axis=1)


class _TorchStandIn(nn.Module):
    """The same function, (B, 3, C, H, W); the parameter only places it."""

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return torch.stack([x - torch.sqrt(x.abs() + 0.05), x, x + torch.sqrt(x.abs() + 0.1)], 1)


@pytest.fixture(scope="module")
def stand_ins():
    cfg = dict(CONFIG, num_lambdas=40)
    return (jasm.UQState(model=_JaxStandIn(), variables={}, params=cfg),
            tasm.UQState(model=_TorchStandIn(), params=cfg), cfg)


def test_validation_table_and_lambda_hat_match_exactly_on_shared_outputs(stand_ins):
    jstate, tstate, cfg = stand_ins
    ds = SyntheticDataset(num_examples=10, image_size=32, seed=40)
    want = jevaluate.get_loss_table(jstate, ds, cfg)
    got = tevaluate.get_loss_table(tstate, ds, cfg)
    assert got.shape == (10, 40) and 0.0 < got.mean() < 1.0
    np.testing.assert_array_equal(got, want)
    calib = SyntheticDataset(num_examples=12, image_size=32, seed=41)
    for alpha in (0.1, 0.3):
        c = dict(cfg, alpha=alpha)
        js, jt = jrcps.calibrate_model(jstate, calib, c, method="direct")
        ts, tt = trcps.calibrate_model(tstate, calib, c)
        assert ts.lhat == js.lhat
        np.testing.assert_array_equal(tt, jt)


def test_set_metrics_match_exactly_on_shared_outputs(stand_ins):
    jstate, tstate, cfg = stand_ins
    ds = SyntheticDataset(num_examples=10, image_size=32, seed=42)  # batches of 4, 4, 2 (+2 pad)
    want = jmetrics.eval_set_metrics(jstate, ds, cfg, lam=1.3, rng=np.random.RandomState(5))
    got = tmetrics.eval_set_metrics(tstate, ds, cfg, lam=1.3, rng=np.random.RandomState(5))
    assert got.risk == want.risk and got.spearman == want.spearman and got.mse == want.mse
    for field in ("losses", "stratified_risks", "spatial_miscoverage"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    # XLA's CPU compiler contracts pred + λ·du into one fused multiply-add;
    # PyTorch rounds the product first, so a size can differ by one f32 ulp
    np.testing.assert_allclose(got.sizes, want.sizes, rtol=2.0**-23, atol=0)
    got_only = tmetrics.eval_risk_only(tstate.set_lhat(1.3), ds, cfg)
    np.testing.assert_allclose(got_only, jmetrics.eval_risk_only(jstate.set_lhat(1.3), ds, cfg),
                               rtol=1e-6)


# ---------------------------------------------------- a shared UNet


@pytest.fixture(scope="module")
def shared_unet(runs):
    jstate = runs["jax_state"]
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    tstate = tasm.add_uncertainty(tasm.build_trunk(CONFIG), CONFIG, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    return jstate, tstate.set_lhat(jstate.lhat)


def test_lambda_hat_and_table_match_on_jax_trained_weights(shared_unet):
    jstate, tstate = shared_unet
    ds = SyntheticDataset(num_examples=16, image_size=32, seed=43)
    want = jevaluate.get_loss_table(jstate, ds, CONFIG)
    got = tevaluate.get_loss_table(tstate, ds, CONFIG)
    assert (got != want).mean() <= 5e-3
    js, jt = jrcps.calibrate_model(jstate, ds, CONFIG, method="direct")
    ts, tt = trcps.calibrate_model(tstate, ds, CONFIG)
    assert ts.lhat == js.lhat
    assert (tt != jt).mean() <= 5e-3


def test_set_metrics_match_on_jax_trained_weights(shared_unet):
    jstate, tstate = shared_unet
    ds = SyntheticDataset(num_examples=12, image_size=32, seed=44)
    want = jmetrics.eval_set_metrics(jstate, ds, CONFIG, lam=2.0, rng=np.random.RandomState(6))
    got = tmetrics.eval_set_metrics(tstate, ds, CONFIG, lam=2.0, rng=np.random.RandomState(6))
    assert abs(got.risk - want.risk) <= 5e-3
    np.testing.assert_allclose(got.sizes, want.sizes, rtol=1e-4)
    np.testing.assert_allclose(got.mse, want.mse, rtol=1e-4)
    assert abs(got.spearman - want.spearman) <= 1e-2
    assert np.abs(got.spatial_miscoverage - want.spatial_miscoverage).mean() <= 5e-3
