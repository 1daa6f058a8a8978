"""Port parity: ``scripts/export_torch.py`` and ``scripts/import_torch.py``.

- ``export_torch.export_state_dict`` of a port model is the JAX package's
  ``interop/torch_export.export_state_dict`` of the same weights bit for bit
  (keys, dtypes, values; ``num_batches_tracked`` 0 as the JAX export writes
  it, ``lhat`` a float32 scalar), for UNet and WNet and the heads, after a
  train-mode forward has moved the statistics and the counters. The JAX
  tree comes from the port's weights through the JAX package's
  ``interop/torch_import.port_state_dict``, which jits nothing.
- The CLIs chain across the two packages: the port's ``export_torch`` on
  a port checkpoint, the JAX ``import_torch`` on its ``.pth``, the JAX
  ``export_torch`` on the JAX checkpoint it wrote, and the port's
  ``import_torch`` on that: the weights (but the counters) and λ̂ come back
  bit for bit, and each ``.pth`` is the other side's bit for bit.
- The port's ``import_torch`` parses the epoch from a ``CP_epoch{e}_``
  name, takes ``--lhat``, writes the calibrated artifact only when λ̂ is
  known, and unpickles a whole module only with ``--reference-path``
  pointing at the code that defines it (a module written here, since the
  reference repo is not in this checkout).
"""

from __future__ import annotations

import os
import shutil
import sys

import pytest
import torch
import yaml

from im2im_uq_tpu.interop.torch_export import export_state_dict as jax_export
from im2im_uq_tpu.interop.torch_import import port_state_dict
from im2im_uq_tpu.scripts import export_torch as jexport_cli
from im2im_uq_tpu.scripts import import_torch as jimport_cli
from im2im_uq_tpu.training import checkpoint as jckpt

from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.scripts import export_torch, import_torch
from im2im_uq_tpu_torch.training import checkpoint as tckpt
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = {"model": "UNet", "uncertainty_type": "quantiles", "q_lo": 0.05, "q_hi": 0.95,
       "q_lo_weight": 1.0, "q_hi_weight": 1.0, "mse_weight": 1.0, "dataset": "synthetic",
       "batch_size": 4, "lr": 1e-3, "input_normalization": "standard",
       "output_normalization": "min-max", "epochs": 3, "num_softmax": 8,
       "resize_backend": "xla", "lane_pack": False}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied when the test ends: one checkpoint of the
    full-width model with Adam's state takes about 207 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trained_forward(cfg, seed=0):
    """A seeded port model after one train-mode forward (statistics and
    counters moved)."""
    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                              generator=torch.Generator().manual_seed(seed), device="cpu")
    st.model.train()
    with torch.no_grad():
        st.model(torch.randn(2, int(cfg.get("num_inputs", 1)), 16, 16,
                             generator=torch.Generator().manual_seed(seed + 1)))
    st.model.eval()
    return st


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("model, utype, lhat", [
    ("UNet", "quantiles", 1.5), ("WNet", "gaussian", None), ("UNet", "softmax", 0.3),
])
def test_export_state_dict_is_the_jax_export_bit_for_bit(model, utype, lhat):
    cfg = dict(CFG, model=model, uncertainty_type=utype, num_inputs=2 if model == "WNet" else 1)
    st = _trained_forward(cfg)
    assert any(int(v) > 0 for k, v in st.model.state_dict().items()
               if k.endswith("num_batches_tracked"))
    params, stats = port_state_dict(st.model.state_dict(), model, utype)
    want = jax_export({"params": params, "batch_stats": stats}, model, utype, lhat=lhat)
    _same(export_torch.export_state_dict(st.model, lhat), want)


def _write_config(tmp_path, cfg) -> str:
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_clis_round_trip_through_the_jax_package(tmp_path):
    cfg_path = _write_config(tmp_path, CFG)
    st = _trained_forward(CFG).replace(lhat=0.875)
    ckpt = tckpt.save_calibrated_checkpoint(st, CFG, str(tmp_path / "port"))
    pth = str(tmp_path / "port.pth")
    assert export_torch.main(["--checkpoint", ckpt, "--config", cfg_path, "--output", pth,
                              "--device", "cpu"]) == 0
    exported = torch.load(pth, weights_only=True)
    assert float(exported["lhat"]) == 0.875

    jdir = str(tmp_path / "jax")
    assert jimport_cli.main(["--checkpoint", pth, "--config", cfg_path, "--output-dir", jdir]) == 0
    jcal = jckpt.calibrated_checkpoint_path(jdir, CFG)
    assert os.path.exists(jckpt.checkpoint_path(jdir, CFG["epochs"], CFG)) and os.path.exists(jcal)
    jpth = str(tmp_path / "jax.pth")
    assert jexport_cli.main(["--checkpoint", jcal, "--config", cfg_path, "--output", jpth]) == 0
    _same(torch.load(jpth, weights_only=True), exported)

    pdir = str(tmp_path / "back")
    assert import_torch.main(["--checkpoint", jpth, "--config", cfg_path, "--output-dir", pdir,
                              "--device", "cpu"]) == 0
    back = torch.load(tckpt.calibrated_checkpoint_path(pdir, CFG), weights_only=True)
    assert back["lhat"] == 0.875
    original = torch.load(ckpt, weights_only=True)["state_dict"]
    for k, v in original.items():
        want = torch.zeros_like(v) if k.endswith("num_batches_tracked") else v
        assert torch.equal(back["state_dict"][k], want), k
    resumable = torch.load(tckpt.checkpoint_path(pdir, CFG["epochs"], CFG), weights_only=True)
    assert resumable["epoch"] == CFG["epochs"] and resumable["optimizer"]["state"] == {}


def test_import_epoch_name_lhat_override_and_no_artifact_without_lhat(tmp_path):
    cfg_path = _write_config(tmp_path, CFG)
    st = _trained_forward(CFG)
    pth = str(tmp_path / "CP_epoch7_synthetic_quantiles.pth")
    torch.save(export_torch.export_state_dict(st.model), pth)
    out = str(tmp_path / "a")
    assert import_torch.main(["--checkpoint", pth, "--config", cfg_path, "--output-dir", out,
                              "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == [os.path.basename(tckpt.checkpoint_path(out, 7, CFG))]
    out = str(tmp_path / "b")
    assert import_torch.main(["--checkpoint", pth, "--config", cfg_path, "--output-dir", out,
                              "--lhat", "0.25", "--epoch", "2", "--device", "cpu"]) == 0
    assert torch.load(tckpt.checkpoint_path(out, 2, CFG), weights_only=True)["lhat"] == 0.25
    assert torch.load(tckpt.calibrated_checkpoint_path(out, CFG), weights_only=True)["lhat"] == 0.25


_REFERENCE_MODULE = '''
import torch


class ModelWithUncertainty(torch.nn.Module):
    def __init__(self, base, last):
        super().__init__()
        self.baseModel = base
        self.last_layer = last
        self.register_buffer("lhat", None)

    def set_lhat(self, lhat):
        self.lhat = lhat
'''


def test_a_whole_pickled_module_needs_the_reference_path(tmp_path):
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "refmodel_for_import_test.py").write_text(_REFERENCE_MODULE)
    sys.path.insert(0, str(ref))
    try:
        import refmodel_for_import_test as refmod

        st = _trained_forward(CFG)
        module = refmod.ModelWithUncertainty(st.model.baseModel, st.model.last_layer)
        module.set_lhat(torch.tensor(0.5))
        pth = str(tmp_path / "whole.pth")
        torch.save(module, pth)
    finally:
        sys.path.remove(str(ref))
        sys.modules.pop("refmodel_for_import_test", None)
    cfg_path = _write_config(tmp_path, CFG)
    out = str(tmp_path / "out")
    args = ["--checkpoint", pth, "--config", cfg_path, "--output-dir", out, "--device", "cpu"]
    with pytest.raises(ModuleNotFoundError):
        import_torch.main(args)
    assert import_torch.main(args + ["--reference-path", str(ref)]) == 0
    assert str(ref) not in sys.path
    back = torch.load(tckpt.calibrated_checkpoint_path(out, CFG), weights_only=True)
    assert back["lhat"] == 0.5
    for k, v in st.model.state_dict().items():
        assert torch.equal(back["state_dict"][k], v), k
    sd, lhat = import_torch.load_reference_state_dict(pth, str(ref))
    assert lhat == 0.5 and "lhat" not in sd
