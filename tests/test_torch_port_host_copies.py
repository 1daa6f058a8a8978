"""The port's copies of the JAX package's host modules give the JAX modules'
results on the same inputs, and the port leaves the CPU only when asked.

The port imports nothing of ``im2im_uq_tpu`` (``test_torch_port_imports``);
it keeps its own copies of the host code it shares with it: the RCPS
bounds, the datasets and host batching, the config loader, the metrics
logger, the JAX-to-port weight layout, and the fastMRI extras (the slice
datasets of ``data/mri_data.py``, the volume shard sampler and
``utils/misc.py``). Each is held here to its JAX original: the same items,
batches, splits, bounds, configs, log lines, images, shards and state
dicts, bit for bit. Datasets that read files (FastMRI, TEMCA, CIFAR-10,
BSBCM) read small ones written here.
"""

from __future__ import annotations

import inspect
import json
import os
import pathlib
import pickle
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu.calibration import bounds as jbounds
from im2im_uq_tpu.data import bsbcm as jbsbcm
from im2im_uq_tpu.data import cifar10 as jcifar
from im2im_uq_tpu.data import core as jcore
from im2im_uq_tpu.data import fastmri as jfastmri
from im2im_uq_tpu.data import mri_data as jmri_data
from im2im_uq_tpu.data import normalize as jnorm
from im2im_uq_tpu.data import subsample as jsub
from im2im_uq_tpu.data import synthetic as jsyn
from im2im_uq_tpu.data import temca as jtemca
from im2im_uq_tpu.data import transforms as jtf
from im2im_uq_tpu.data import volume_sampler as jsampler
from im2im_uq_tpu.interop.torch_export import export_state_dict
from im2im_uq_tpu.interop.torch_import import port_state_dict
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.parallel import mesh as jmesh
from im2im_uq_tpu.scripts import plots as jplots
from im2im_uq_tpu.utils import config as jconfig
from im2im_uq_tpu.utils import logging as jlog
from im2im_uq_tpu.utils import misc as jmisc

from im2im_uq_tpu_torch.calibration import bounds as tbounds
from im2im_uq_tpu_torch.data import bsbcm as tbsbcm
from im2im_uq_tpu_torch.data import cifar10 as tcifar
from im2im_uq_tpu_torch.data import core as tcore
from im2im_uq_tpu_torch.data import fastmri as tfastmri
from im2im_uq_tpu_torch.data import mri_data as tmri_data
from im2im_uq_tpu_torch.data import normalize as tnorm
from im2im_uq_tpu_torch.data import subsample as tsub
from im2im_uq_tpu_torch.data import synthetic as tsyn
from im2im_uq_tpu_torch.data import temca as ttemca
from im2im_uq_tpu_torch.data import transforms as ttf
from im2im_uq_tpu_torch.data import volume_sampler as tsampler
from im2im_uq_tpu_torch.interop.from_jax import state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.parallel import mesh as tmesh
from im2im_uq_tpu_torch.scripts import plots as tplots
from im2im_uq_tpu_torch.scripts import router as trouter
from im2im_uq_tpu_torch.utils import config as tconfig
from im2im_uq_tpu_torch.utils import logging as tlog
from im2im_uq_tpu_torch.utils import misc as tmisc
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
EXPERIMENT_CONFIGS = sorted(str(p.relative_to(REPO)) for p in REPO.glob("experiments/**/*.yml"))


def _same_pairs(got, want) -> None:
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw", [dict(num_examples=5, image_size=16, seed=0),
                                dict(num_examples=3, image_size=24, num_channels_in=2, seed=7)])
def test_synthetic_items_match(kw):
    t, j = tsyn.SyntheticDataset(**kw), jsyn.SyntheticDataset(**kw)
    _same_pairs((t[i] for i in range(len(t))), (j[i] for i in range(len(j))))


@pytest.mark.parametrize("pad_mode", ["wrap", "zeros"])
def test_iterate_batches_match(pad_mode):
    ds = jsyn.SyntheticDataset(num_examples=7, image_size=8, seed=3)
    kw = dict(shuffle=True, pad_mode=pad_mode)
    got = tcore.iterate_batches(ds, 3, rng=np.random.RandomState(4), **kw)
    want = jcore.iterate_batches(ds, 3, rng=np.random.RandomState(4), **kw)
    _same_pairs(got, want)


def test_splits_match():
    assert tcore.split_lengths(97, [0.6, 0.2, 0.1, 0.1]) == jcore.split_lengths(97, [0.6, 0.2, 0.1, 0.1])
    ds = jsyn.SyntheticDataset(num_examples=20, image_size=8, seed=5)
    got = tcore.random_split(ds, [12, 5, 3], np.random.RandomState(6))
    want = jcore.random_split(ds, [12, 5, 3], np.random.RandomState(6))
    assert [list(s.indices) for s in got] == [list(s.indices) for s in want]


def test_bounds_match_on_a_grid():
    muhats = np.linspace(0.0, 0.6, 25)
    for n in (10, 200):
        for delta in (0.1, 0.01):
            for m in muhats:
                assert tbounds.HB_mu_plus(m, n, delta) == jbounds.HB_mu_plus(m, n, delta)
            np.testing.assert_array_equal(tbounds.hb_mu_plus_grid(muhats, n, delta),
                                          jbounds.hb_mu_plus_grid(muhats, n, delta))
    x = np.random.RandomState(8).uniform(0.0, 0.5, 60)
    for delta in (0.1, 0.01):
        assert tbounds.WSR_mu_plus(x, delta) == jbounds.WSR_mu_plus(x, delta)


@pytest.mark.parametrize("path", EXPERIMENT_CONFIGS)
def test_load_config_matches_on_every_experiment(path):
    assert tconfig.load_config(REPO / path) == jconfig.load_config(REPO / path)


def test_defaults_match():
    assert tconfig.DEFAULTS == jconfig.DEFAULTS


def test_metrics_logger_lines_match(tmp_path):
    records = [{"epoch": 1, "loss": np.float32(0.25), "table": np.arange(3.0)},
               {"risk": torch.tensor(0.5), "sizes": [1, 2], "tag": "val"}]
    for mod, name in ((tlog, "port"), (jlog, "jax")):
        logger = mod.MetricsLogger(str(tmp_path / name), use_wandb=False)
        for r in records:
            logger.log(r)
        logger.close()
    lines = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "metrics.jsonl") as fh:
            lines[name] = [{k: v for k, v in json.loads(ln).items() if k != "_time"} for ln in fh]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 2


def test_to_uint8_image_matches():
    x = np.random.RandomState(9).randn(1, 12, 10, 1).astype(np.float32)
    for norm in (True, False):
        np.testing.assert_array_equal(tlog.to_uint8_image(x, norm), jlog.to_uint8_image(x, norm))


def test_normalization_matches():
    x = np.random.RandomState(10).rand(6, 8, 8, 1).astype(np.float32) * 3 + 1
    for kind in ("standard", "min-max"):
        for per_pixel in (False, True):
            gt, gp = tnorm.normalize_array(x, kind, per_pixel, "input")
            jt, jp = jnorm.normalize_array(x, kind, per_pixel, "input")
            np.testing.assert_array_equal(gt, jt)
            assert gp.keys() == jp.keys()
            for k in gp:
                np.testing.assert_array_equal(gp[k], jp[k])
    ds = jsyn.SyntheticDataset(num_examples=6, image_size=8, seed=11)
    assert tnorm.compute_norm_params(ds) == jnorm.compute_norm_params(ds)
    np.testing.assert_array_equal(ttf.normalize_instance(x)[0], jtf.normalize_instance(x)[0])


def test_fastmri_items_match(tmp_path):
    jfastmri.write_synthetic_volume(str(tmp_path / "vol0.h5"), seed=0)
    jfastmri.write_synthetic_volume(str(tmp_path / "vol1.h5"), seed=1)
    mask_info = {"type": "random", "center_fraction": [0.08], "acceleration": [4]}
    items = {}
    for mod in (tfastmri, jfastmri):
        random.seed(12)
        ds = mod.FastMRIDataset(str(tmp_path), "standard", "min-max", mask_info)
        ds.transform.mask_func.rng.seed(13)
        items[mod] = [ds[i] for i in range(len(ds))]
    _same_pairs(items[tfastmri], items[jfastmri])
    for mask_type in ("random", "equispaced"):
        t = tsub.create_mask_for_mask_type(mask_type, [0.08], [4])
        j = jsub.create_mask_for_mask_type(mask_type, [0.08], [4])
        np.testing.assert_array_equal(t((1, 40, 2), seed=14), j((1, 40, 2), seed=14))


def test_temca_pairs_match(tmp_path):
    import imageio

    rng = np.random.RandomState(15)
    for i in range(3):
        img = (rng.rand(40, 48) * 255).astype(np.uint8)
        img[:20, :24] = 0  # a patch the zero-fraction rule drops
        imageio.imwrite(tmp_path / f"tile{i}.png", img)
    pairs = {}
    for mod in (ttemca, jtemca):
        random.seed(16)
        ds = mod.TEMCADataset(str(tmp_path) + "/", patch_size=(20, 24), downsampling=(4, 4),
                              buffer_size=2)
        pairs[mod] = list(ds)
    _same_pairs(pairs[ttemca], pairs[jtemca])


def test_cifar10_and_bsbcm_items_match(tmp_path):
    rng = np.random.RandomState(17)
    for i in range(1, 6):
        with open(tmp_path / f"data_batch_{i}", "wb") as fh:
            pickle.dump({b"data": (rng.rand(2, 3072) * 255).astype(np.uint8)}, fh)
    t, j = tcifar.CIFAR10Dataset(str(tmp_path), seed=1), jcifar.CIFAR10Dataset(str(tmp_path), seed=1)
    _same_pairs((t[i] for i in range(len(t))), (j[i] for i in range(len(j))))
    np.save(tmp_path / "X.npy", rng.rand(4, 8, 8, 1).astype(np.float32))
    np.save(tmp_path / "Y.npy", rng.rand(4, 8, 8, 1).astype(np.float32))
    t = tbsbcm.BSBCMDataset(str(tmp_path), normalize="min-max")
    j = jbsbcm.BSBCMDataset(str(tmp_path), normalize="min-max")
    _same_pairs((t[i] for i in range(len(t))), (j[i] for i in range(len(j))))


def test_weight_carrier_matches_export_state_dict_bit_for_bit():
    cfg = {"model": "UNet", "uncertainty_type": "quantiles", "resize_backend": "xla"}
    jstate = jasm.add_uncertainty(jasm.build_trunk(cfg), cfg, rng=jax.random.key(3),
                                  example_input=jnp.zeros((1, 16, 16, 1)))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    got = state_dict_from_jax(variables, "UNet", "quantiles")
    want = export_state_dict(variables, "UNet", "quantiles")
    assert list(got) == list(want) and len(got) == 134
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_add_uncertainty_places_on_the_card_unless_asked():
    assert inspect.signature(tasm.add_uncertainty).parameters["device"].default == "cuda"


@pytest.mark.parametrize("model, utype, count", [
    ("UNet", "softmax", 130), ("WNet", "gaussian", 202)])
def test_weight_carrier_matches_export_state_dict_for_every_layout(model, utype, count):
    """The softmax head's out{c} → output_layers.{c} and WNet's p1*/p2*
    encoders, bit for bit, and a strict load into the port's model. The
    JAX variables come from a port model through the JAX package's
    ``torch_import.port_state_dict`` (no JAX init to compile)."""
    cfg = {"model": model, "uncertainty_type": utype, "num_softmax": 7}
    seed = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                generator=torch.Generator().manual_seed(4), device="cpu")
    params, stats = port_state_dict(seed.model.state_dict(), model, utype)
    variables = {"params": params, "batch_stats": stats}
    got = state_dict_from_jax(variables, model, utype)
    want = export_state_dict(variables, model, utype)
    assert list(got) == list(want) and len(got) == count
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    tstate = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    tstate.model.load_state_dict(got, strict=True)


def test_mesh_batch_rounding_matches():
    """``mesh_batch_size`` and ``pad_to_multiple`` are copied verbatim; on
    meshes of 1, 2 and 8 ranks / devices they round alike and warn alike,
    once per (batch, mesh size)."""
    for fn in ("mesh_batch_size", "pad_to_multiple"):
        assert inspect.getsource(getattr(tmesh, fn)) == inspect.getsource(getattr(jmesh, fn))
    for n in (1, 2, 8):
        jm = jmesh.data_parallel_mesh(n)
        tm = tmesh.Mesh(group=None, size=n, rank=0, device=torch.device("cpu"))
        for b in (1, 7, 8, 78):
            assert tmesh.mesh_batch_size(b, tm) == jmesh.mesh_batch_size(b, jm)
            assert tmesh.pad_to_multiple(b, n) == jmesh.pad_to_multiple(b, n)
    assert tmesh.mesh_batch_size(78, None) == jmesh.mesh_batch_size(78, None) == 78
    assert (78, 8) in tmesh._ROUNDING_WARNED and (78, 8) in jmesh._ROUNDING_WARNED


# ------------------------------------------------- the fastMRI extras


@pytest.fixture()
def volume_dir(tmp_path):
    d = tmp_path / "vols"
    d.mkdir()
    for i in range(3):
        jfastmri.write_synthetic_volume(str(d / f"vol{i}.h5"), num_slices=4, seed=i)
    return d


def _same_slices(got, want) -> None:
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("kw", [{}, {"sample_rate": 0.5}, {"volume_sample_rate": 0.34},
                                {"num_cols": (40,)}])
def test_slice_datasets_match(volume_dir, kw):
    out = {}
    for mod in (tmri_data, jmri_data):
        random.seed(18)
        out[mod] = mod.SliceDataset(volume_dir, challenge="singlecoil", **kw)
    assert [e[:2] for e in out[tmri_data].examples] == [e[:2] for e in out[jmri_data].examples]
    _same_slices(out[tmri_data], out[jmri_data])
    with pytest.raises(ValueError):
        tmri_data.SliceDataset(volume_dir, challenge="bogus")


def test_slice_dataset_cache_and_combined_datasets_match(volume_dir, tmp_path):
    transform = ttf.UnetDataTransform("singlecoil")
    combined = {}
    for mod, name in ((tmri_data, "port"), (jmri_data, "jax")):
        cache = tmp_path / f"{name}.pkl"
        mod.SliceDataset(volume_dir, challenge="singlecoil", use_dataset_cache=True,
                         dataset_cache_file=cache)
        with open(cache, "rb") as fh:
            assert len(pickle.load(fh)[volume_dir]) == 12
        combined[name] = mod.CombinedSliceDataset(
            [volume_dir, volume_dir], ["singlecoil", "singlecoil"], [transform, None])
    assert len(combined["port"]) == len(combined["jax"]) == 24
    for i in (0, 11, 12, 23):
        _same_slices([combined["port"][i]], [combined["jax"][i]])
    with pytest.raises(IndexError):
        combined["port"][24]


def test_fetch_dir_matches(tmp_path):
    for mod, name in ((tmri_data, "port"), (jmri_data, "jax")):
        cfg = tmp_path / f"{name}.yaml"
        with pytest.warns(UserWarning):
            assert str(mod.fetch_dir("knee_path", cfg)) == "/path/to/knee"
        cfg.write_text("knee_path: /data/knee\nbrain_path: /b\nlog_path: .\n")
        assert str(mod.fetch_dir("brain_path", cfg)) == "/b"
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_volume_shard_samplers_match(shards):
    names = ["a.h5"] * 4 + ["b.h5"] * 2 + ["c.h5"] * 5 + ["d.h5"] * 1 + ["e.h5"] * 3
    for k in range(shards):
        for shuffle in (False, True):
            t = tsampler.VolumeShardSampler(names, shards, k, shuffle=shuffle, seed=5)
            j = jsampler.VolumeShardSampler(names, shards, k, shuffle=shuffle, seed=5)
            for epoch in (0, 1):
                t.set_epoch(epoch)
                j.set_epoch(epoch)
                assert t.indices() == j.indices() and list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError, match="out of range"):
        tsampler.VolumeShardSampler(names, shards, shards)


def test_misc_matches(tmp_path, monkeypatch):
    cfg = {"output_mean": 2.0, "output_std": 4.0, "output_min": -6.0, "output_max": 10.0,
           "input_mean": 1.0, "input_std": 2.0, "input_min": -1.0, "input_max": 3.0}
    x = np.array([0.0, 1.0, -2.5])
    for out in (True, False):
        np.testing.assert_array_equal(tmisc.standard_to_minmax(x, cfg, out),
                                      jmisc.standard_to_minmax(x, cfg, out))
    calls = []

    @tmisc.cacheable
    def add(a, b):
        calls.append((a, b))
        return a + b

    monkeypatch.setattr(pathlib.Path, "absolute", lambda self: tmp_path)
    assert add(2, 3) == add(2, 3) == 5 and calls == [(2, 3)]
    assert (tmp_path / ".cache" / "add(2, 3).pkl").exists()
    for mod, name in ((tmisc, "port"), (jmisc, "jax")):
        mod.plot_loss([3.0, 2.0, 1.5], 10, str(tmp_path / name / "loss.png"))
        assert (tmp_path / name / "loss.png").stat().st_size > 0


def test_misc_imports_matplotlib_only_to_plot():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = ("import sys, im2im_uq_tpu_torch.utils.misc as m; "
            "assert 'matplotlib' not in sys.modules, 'imported'; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _router_artifacts(tmp_path, torch_pickled: bool):
    """A results pickle and a loss table as the port's router writes them
    (``pickle.dump`` of numpy values under the JAX router's keys), or as the
    reference writes them (``pickle.dump`` of torch tensors, the table by
    ``torch.save``)."""
    r = np.random.RandomState(3)
    results = {"risk": 0.08, "sizes": r.rand(6), "spearman": 0.4,
               "size-stratified risk": r.rand(4), "mse": 0.01,
               "spatial_miscoverage": r.rand(8, 8), "lhat": 1.5,
               "inputs": r.rand(2, 8, 8, 1), "gt": r.rand(2, 8, 8, 1),
               "predictions": r.rand(2, 8, 8, 1), "lower_edge": r.rand(2, 8, 8, 1),
               "upper_edge": 1 + r.rand(2, 8, 8, 1)}
    table = (r.rand(40, 20) > np.linspace(0, 1, 20)).astype(np.float32)
    cfg = {"output_dir": str(tmp_path), "dataset": "synthetic", "uncertainty_type": "quantiles",
           "batch_size": 4, "lr": 1e-3, "input_normalization": "standard",
           "output_normalization": "min-max"}
    res_path, table_path = trouter.results_filename(cfg), trouter.loss_table_filename(cfg)
    if torch_pickled:
        results = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in results.items()}
        torch.save(torch.as_tensor(table), table_path)
    with open(res_path, "wb") as fh:
        pickle.dump(results, fh, protocol=pickle.HIGHEST_PROTOCOL)
    if not torch_pickled:
        with open(table_path, "wb") as fh:
            pickle.dump(table, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return res_path, table_path


@pytest.mark.parametrize("torch_pickled", [False, True])
def test_plots_load_router_artifacts_as_the_jax_module(tmp_path, torch_pickled):
    res_path, table_path = _router_artifacts(tmp_path, torch_pickled)
    got, want = tplots.load_results(res_path), jplots.load_results(res_path)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    table = tplots.load_loss_table(table_path)
    np.testing.assert_array_equal(table, jplots.load_loss_table(table_path))
    assert table.shape == (40, 20)


def test_plots_risks_and_figures_match(tmp_path):
    res_path, table_path = _router_artifacts(tmp_path, False)
    table = tplots.load_loss_table(table_path)
    got = tplots.compute_risks(table, 20, 0.1, 0.1, num_trials=5, rng=np.random.RandomState(4))
    want = jplots.compute_risks(table, 20, 0.1, 0.1, num_trials=5, rng=np.random.RandomState(4))
    np.testing.assert_array_equal(got, want)
    out = tmp_path / "figures"
    tplots.generate_plots(["a method"], [res_path], [table_path], outdir=str(out), prefix="t",
                          num_trials=3)
    for name in ("t-risks.pdf", "t-mse.pdf", "t-spearman.pdf", "t-sizes.pdf",
                 "t-size-stratified-risk.pdf", "images/1/mixed_output.png",
                 "spatial_miscoverage/t_spatial_miscoverage_a method.png"):
        assert (out / name).stat().st_size > 0, name


def test_plots_import_no_plotting_library():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = ("import sys, im2im_uq_tpu_torch.scripts.plots as p; "
            "bad = [m for m in ('matplotlib', 'seaborn', 'pandas', 'PIL') if m in sys.modules]; "
            "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
