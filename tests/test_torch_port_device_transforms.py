"""Port parity: the on-device input transforms and the train step's hooks.

- FastMRI: ``FastMRIDataset.device_preprocess`` against the JAX package's
  closure on the same raw k-space batch of two small synthetic volumes
  (rtol 1e-5 / atol 1e-6, the bars of ``test_torch_port_fftc.py``), and
  against the port's image-mode items of the same slices and masks (the
  JAX test's rtol 2e-4 / atol 1e-5 against numpy's FFT).
- TEMCA: the raw-uint8 feed ships each patch once as input and target;
  ``device_preprocess_pair`` gives the port's host pairs bit for bit, and
  the JAX package's within its 1-ulp bar (rtol 2e-7 / atol 5e-7,
  ``tests/test_temca_device.py``: XLA divides by 255 as a reciprocal
  multiply), for "01" and "-11" and two downsamplings.
- One train step with each hook against the JAX package's step with the
  same hook on the same weights (the JAX init through
  ``interop/from_jax.state_dict_from_jax``): FastMRI's in float64 on both
  sides (loss to 1e-12, every gradient within 1e-6 relative L2, as
  ``test_torch_port_train.py`` holds the f64 step), TEMCA's in float32 (the
  loss within that file's 1e-5), and TEMCA's hook step bit for bit the
  port's image-mode step on the host pairs. The eval step takes the same
  hooks. Passing both hooks raises the JAX message; a raw batch on another
  device than the model's raises.
"""

from __future__ import annotations

import random
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.data import fastmri as jfastmri
from im2im_uq_tpu.data import temca as jtemca
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.data import fastmri as tfastmri
from im2im_uq_tpu_torch.data import temca as ttemca
from im2im_uq_tpu_torch.data.normalize import normalize_dataset
from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.full  # compiles two JAX train steps

CFG = dict(DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
           lane_pack=False, dataset="fastmri", batch_size=4, lr=1e-3)
MASK = {"type": "equispaced", "center_fraction": [0.08], "acceleration": [4]}
CROP = (16, 16)
PATCH = (32, 32)
ULP_RTOL, ULP_ATOL = 2e-7, 5e-7


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two synthetic fastMRI volumes (k-space 24x20, recon 16x16) and the
    port's dataset over them, normalised in image mode, per-file masks."""
    root = tmp_path_factory.mktemp("vols")
    for i in range(2):
        tfastmri.write_synthetic_volume(str(root / f"v{i}.h5"), num_slices=3,
                                        enc_shape=(24, 20), recon_shape=CROP, seed=i)
    random.seed(0)
    ds = normalize_dataset(tfastmri.FastMRIDataset(str(root), "standard", "min-max", MASK))
    ds.transform.use_seed = True  # the same mask for a slice in both modes
    images = [ds[i] for i in range(len(ds))]
    ds.return_kspace = True
    raw = [ds[i] for i in range(len(ds))]
    ds.return_kspace = False
    return {"ds": ds, "images": images, "raw": raw}


def test_kspace_items_are_the_raw_feed(volumes):
    for (k, y_raw), (x, y) in zip(volumes["raw"], volumes["images"]):
        assert k.shape == (24, 20, 2) and k.dtype == np.float32
        assert x.shape == y.shape == (*CROP, 1)
        np.testing.assert_array_equal(y_raw, y)


def test_device_preprocess_matches_jax_and_the_image_items(volumes):
    ds = volumes["ds"]
    kspace = np.stack([k for k, _ in volumes["raw"]])
    got = ds.device_preprocess(CROP)(torch.from_numpy(kspace))
    assert got.shape == (len(kspace), 1, *CROP) and got.dtype == torch.float32
    like = SimpleNamespace(normalize_input=ds.normalize_input, norm_params=ds.norm_params)
    want = np.asarray(jfastmri.FastMRIDataset.device_preprocess(like, CROP)(jnp.asarray(kspace)))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-6)
    images = np.stack([x for x, _ in volumes["images"]]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), images, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["standard", "min-max", "none"])
def test_device_preprocess_normalises_as_jax(which):
    params = {"input_mean": 0.3, "input_std": 1.7, "input_min": -0.2, "input_max": 2.5}
    like = SimpleNamespace(normalize_input=which, norm_params=params)
    kspace = np.random.RandomState(3).randn(2, 24, 20, 2).astype(np.float32)
    got = tfastmri.FastMRIDataset.device_preprocess(like, CROP)(torch.from_numpy(kspace))
    want = jfastmri.FastMRIDataset.device_preprocess(like, CROP)(jnp.asarray(kspace))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ TEMCA


def _tiles(root, n: int = 2) -> str:
    import imageio

    rng = np.random.RandomState(4)
    for i in range(n):
        imageio.imwrite(root / f"tile{i}.png", rng.randint(1, 255, (64, 64), dtype=np.uint8))
    return str(root) + "/"


def _temca_items(mod, path: str, normalize, down, raw: bool) -> list:
    random.seed(5)
    ds = mod.TEMCADataset(path, patch_size=PATCH, downsampling=down, buffer_size=2,
                          normalize=normalize)
    ds.return_raw = raw
    random.seed(6)  # the buffer shuffles with the global random module
    return ds, list(ds)


def _nchw(items, k: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([it[k] for it in items]).transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("down", [(2, 2), (4, 3)])
@pytest.mark.parametrize("normalize", ["01", "-11"])
def test_device_pair_is_the_host_pair_and_jax_within_one_ulp(tmp_path, normalize, down):
    path = _tiles(tmp_path)
    _, host = _temca_items(ttemca, path, normalize, down, raw=False)
    ds, raw = _temca_items(ttemca, path, normalize, down, raw=True)
    assert len(raw) == len(host) == 8
    for x, y in raw:
        assert x is y and x.dtype == np.uint8 and x.shape == (*PATCH, 1)
    low, gt = ds.device_preprocess_pair()(_nchw(raw, 0), _nchw(raw, 1))
    assert low.dtype == gt.dtype == torch.float32
    assert torch.equal(low, _nchw(host, 0)) and torch.equal(gt, _nchw(host, 1))

    jds, jraw = _temca_items(jtemca, path, normalize, down, raw=True)
    xr = jnp.stack([p[0] for p in jraw])
    jlow, jgt = jax.jit(jds.device_preprocess_pair())(xr, xr)
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow).transpose(0, 3, 1, 2),
                               rtol=ULP_RTOL, atol=ULP_ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt).transpose(0, 3, 1, 2),
                               rtol=ULP_RTOL, atol=ULP_ATOL)


# -------------------------------------------------------- the train step


@pytest.fixture(scope="module")
def variables():
    jstate = jasm.add_uncertainty(jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
                                  example_input=jnp.zeros((1, *CROP, 1)))
    return jstate.model, jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))


def _jax_step(model, variables, dtype, batch, **hooks):
    """One JAX step (Adam) with ``hooks`` → (loss, gradients in the port's
    names, as f64 tensors)."""
    from im2im_uq_tpu.interop.torch_export import export_state_dict

    tx = optax.adam(CFG["lr"])
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
    body = jax.jit(jtrain._train_step_body(model, jheads.head_loss_pe_fn("quantiles"), CFG, tx,
                                           **hooks))
    state = jtrain.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    _, loss, grads = body(state, *batch)
    grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(grads))
    sd = export_state_dict({"params": grads, "batch_stats": variables["batch_stats"]}, "UNet",
                           "quantiles")
    return float(loss), {k: v.double() for k, v in sd.items()
                         if "running" not in k and "num_batches" not in k}


def _port_state(variables, dtype):
    st = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(st.model, variables, "UNet", "quantiles")
    st.model.to(dtype)
    return st


def _port_step(variables, dtype, tensors, **hooks):
    """One port step (Adam) with ``hooks`` → (loss, gradients as f64)."""
    st = _port_state(variables, dtype)
    opt = torch.optim.Adam(st.model.parameters(), lr=CFG["lr"])
    step = ttrain.make_train_step(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt,
                                  **hooks)
    loss = float(step(*tensors))
    return loss, {n: p.grad.double() for n, p in st.model.named_parameters()}


def _feeds_batchnorm(name: str) -> bool:
    return re.search(r"double_conv\.[03]\.bias$", name) is not None


def test_fastmri_hook_step_matches_jax_in_f64(volumes, variables):
    model, v = variables
    ds = volumes["ds"]
    kspace = np.stack([k for k, _ in volumes["raw"][:4]]).astype(np.float64)
    y = np.stack([t for _, t in volumes["raw"][:4]]).astype(np.float64)
    mask = np.array([1, 1, 1, 0], np.float32)
    like = SimpleNamespace(normalize_input=ds.normalize_input, norm_params=ds.norm_params)
    with jax.enable_x64(True):
        want_loss, want = _jax_step(
            model, v, jnp.float64, (jnp.asarray(kspace), jnp.asarray(y), jnp.asarray(mask)),
            preprocess=jfastmri.FastMRIDataset.device_preprocess(like, CROP))
    tensors = ttrain.put_batch(kspace, y, mask, torch.device("cpu"), raw_input=True)
    assert tensors[0].shape == (4, 24, 20, 2)  # the loader's layout, no transpose
    loss, got = _port_step(v, torch.float64, tensors, preprocess=ds.device_preprocess(CROP))
    assert loss == pytest.approx(want_loss, rel=1e-12)
    assert len(got) == len(want) == 80
    for n, g in got.items():
        ref = want[n[:-4] + "weight"] if _feeds_batchnorm(n) else want[n]
        bar = 1e-9 if _feeds_batchnorm(n) else 1e-6  # an exact 0: noise beside the weight's
        assert (g - want[n]).norm() <= bar * ref.norm(), n


def test_temca_hook_step_matches_jax_and_the_image_mode_step(tmp_path, variables):
    model, v = variables
    path = _tiles(tmp_path)
    ds, raw = _temca_items(ttemca, path, "01", (4, 4), raw=True)
    _, host = _temca_items(ttemca, path, "01", (4, 4), raw=False)
    xr = np.stack([p[0] for p in raw[:4]])
    mask = np.array([1, 1, 1, 0], np.float32)
    jds, _ = _temca_items(jtemca, path, "01", (4, 4), raw=True)
    want_loss, _ = _jax_step(model, v, jnp.float32, (jnp.asarray(xr), jnp.asarray(xr),
                                                      jnp.asarray(mask)),
                             preprocess_pair=jds.device_preprocess_pair())
    tensors = ttrain.put_batch(xr, xr, mask, torch.device("cpu"))
    assert tensors[0].dtype == torch.uint8 and tensors[0].shape == (4, 1, *PATCH)
    loss, got = _port_step(v, torch.float32, tensors,
                           preprocess_pair=ds.device_preprocess_pair())
    assert loss == pytest.approx(want_loss, rel=1e-5)
    image = ttrain.put_batch(np.stack([p[0] for p in host[:4]]),
                             np.stack([p[1] for p in host[:4]]), mask, torch.device("cpu"))
    image_loss, image_grads = _port_step(v, torch.float32, image)
    assert loss == image_loss
    assert all(torch.equal(got[n], image_grads[n]) for n in got)


def test_eval_step_takes_the_hook(volumes):
    ds = volumes["ds"]
    st = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                              generator=torch.Generator().manual_seed(1), device="cpu")
    loss_pe = theads.head_loss_pe_fn("quantiles")
    kspace = np.stack([k for k, _ in volumes["raw"][:4]])
    y = np.stack([t for _, t in volumes["raw"][:4]])
    x = np.stack([t for t, _ in volumes["images"][:4]])
    mask = np.ones((4,), np.float32)
    hooked = ttrain.make_eval_loss_step(st.model, loss_pe, CFG,
                                        preprocess=ds.device_preprocess(CROP))
    plain = ttrain.make_eval_loss_step(st.model, loss_pe, CFG)
    got, n = hooked(*ttrain.put_batch(kspace, y, mask, torch.device("cpu"), raw_input=True))
    want, _ = plain(*ttrain.put_batch(x, y, mask, torch.device("cpu")))
    assert int(n) == 4 and float(got) == pytest.approx(float(want), rel=1e-4)


def test_both_hooks_raise_as_jax():
    with pytest.raises(ValueError, match="pass preprocess OR preprocess_pair, not both"):
        jtrain._train_step_body(None, None, CFG, None, preprocess=abs, preprocess_pair=abs)
    st = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    opt = torch.optim.Adam(st.model.parameters())
    for make in (lambda **h: ttrain.make_train_step(st.model, None, CFG, opt, **h),
                 lambda **h: ttrain.make_eval_loss_step(st.model, None, CFG, **h)):
        with pytest.raises(ValueError, match="pass preprocess OR preprocess_pair, not both"):
            make(preprocess=abs, preprocess_pair=abs)


def test_a_raw_batch_off_the_models_device_raises():
    """The hook runs on the model's device: a batch elsewhere is never
    transformed where it lies."""
    st = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="meta")
    opt = torch.optim.Adam(st.model.parameters())
    step = ttrain.make_train_step(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt,
                                  preprocess=lambda k: k)
    with pytest.raises(ValueError, match="on-device transform runs on the model's device"):
        step(torch.zeros(1, 24, 20, 2), torch.zeros(1, 1, 16, 16), torch.ones(1))
