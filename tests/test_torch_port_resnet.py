"""Port parity: the remaining trunks, ResNet18 and ``UNet(bilinear=False)``.

Both are held to the JAX package's modules on the same weights: the JAX
model's variables (its batch statistics randomised, means ~N(0, 0.1),
variances ~U(0.5, 2), so that eval-mode BatchNorm is not the identity) go
into the port through ``interop/from_jax.load_jax_variables``, a strict
load through the layouts that module defines for them. Inputs come from a
seeded RandomState. One JAX init per trunk, shared by the file.

Tolerances, in f32 on the CPU (both sides run their own conv algorithms):

- the eval forward: rtol 1e-4, atol 1e-5, as ``test_torch_port_model.py``;
- the train-mode forward (BatchNorm on batch statistics) and the running
  statistics it leaves: rtol 1e-4, atol 1e-5; the JAX BatchNorm takes the
  batch variance as E[x²] − E[x]² (flax's fast variance), the port's as
  E[(x − E[x])²], which differ by rounding only at these sizes;
- one train step's loss (the masked mean of the quantile loss of the
  train-mode forward, the JAX ``_train_step_body`` with Adam): rtol 1e-5,
  and the loss of the second step (after one Adam update on each side):
  rtol 2e-2, the bar of ``test_torch_port_train.py``, since Adam moves every
  parameter by about lr·sign(g) and a gradient near zero can move the two
  sides apart by 2·lr.

The ConvTranspose mapping (Flax does not flip its kernel) is proven on the
op itself: ``flax.linen.ConvTranspose`` against ``F.conv_transpose2d`` with
the mapped weight, bit for bit up to f32 rounding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.models.unet import UNet as JUNet
from im2im_uq_tpu.training import train as jtrain

from im2im_uq_tpu_torch.interop import from_jax
from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.models.resnet import ResNet18
from im2im_uq_tpu_torch.models.unet import UNet as TUNet
from im2im_uq_tpu_torch.training import train as ttrain

RTOL, ATOL = 1e-4, 1e-5
HEAD = {"uncertainty_type": "quantiles", "q_lo": 0.05, "q_hi": 0.95, "q_lo_weight": 1.0,
        "q_hi_weight": 1.0, "mse_weight": 1.0, "resize_backend": "xla", "lane_pack": False}
RESNET = dict(HEAD, model="ResNet18")
UNET = dict(HEAD, model="UNet")
LR = 1e-3


def _randomise_stats(stats, rng: np.random.RandomState):
    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _pair(jtrunk, ttrunk, cfg, model_name, hw):
    jstate = jasm.add_uncertainty(jtrunk, cfg, rng=jax.random.key(0),
                                  example_input=jnp.zeros((1, *hw, 1)))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 np.random.RandomState(1))}
    jstate = jstate.replace(variables=jax.tree_util.tree_map(jnp.asarray, variables))
    tstate = tasm.add_uncertainty(ttrunk, cfg, device="cpu")
    load_jax_variables(tstate.model, variables, model_name, "quantiles")
    return jstate, tstate, variables


@pytest.fixture(scope="module")
def resnet_pair():
    return _pair(jasm.build_trunk(RESNET), tasm.build_trunk(RESNET), RESNET, "ResNet18", (32, 32))


@pytest.fixture(scope="module")
def unet_pair():
    with torch.device("meta"):
        ttrunk = TUNet(bilinear=False, resize_backend="xla")
    return _pair(JUNet(n_channels_out=1, bilinear=False, resize_backend="xla"), ttrunk, UNET,
                 "UNet", (32, 32))


PAIRS = ["resnet_pair", "unet_pair"]


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 1, 3, 4, 2).numpy()  # (B, K, C, H, W) → (B, K, H, W, C)


def test_conv_transpose_mapping_is_flax_conv_transpose():
    layer = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    x = _x((2, 7, 6, 8), 0)
    v = layer.init(jax.random.key(3), x)
    want = np.asarray(layer.apply(v, x))
    sd: dict = {}
    from_jax._conv_transpose(sd, "", jax.tree_util.tree_map(np.asarray, v["params"]))
    got = F.conv_transpose2d(_nchw(x), sd["weight"], sd["bias"], stride=2)
    assert got.shape == (2, 5, 14, 12)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    # the unflipped reading is a different op
    unflipped = torch.from_numpy(np.ascontiguousarray(
        np.asarray(v["params"]["kernel"]).transpose(2, 3, 0, 1)))
    other = F.conv_transpose2d(_nchw(x), unflipped, sd["bias"], stride=2)
    assert np.abs(other.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_state_dict_layouts():
    with torch.device("meta"):
        resnet = ResNet18()
        unet = TUNet(bilinear=False)
    keys = set(resnet.state_dict())
    assert {"stem.weight", "stem_bn.running_mean", "block2.proj.weight",
            "block2.bn_proj.weight", "out.weight", "out.bias"} <= keys
    assert "stem.bias" not in keys and "block0.proj.weight" not in keys
    assert sum(k.endswith(".proj.weight") for k in keys) == 3
    assert tuple(unet.up1.up.weight.shape) == (1024, 512, 2, 2)
    assert tuple(unet.down4.maxpool_conv[1].double_conv[0].weight.shape) == (1024, 512, 3, 3)
    assert tuple(unet.up1.conv.double_conv[0].weight.shape) == (512, 1024, 3, 3)
    assert tuple(unet.up4.conv.double_conv[3].weight.shape) == (64, 64, 3, 3)


@pytest.mark.parametrize("pair_name", PAIRS)
@pytest.mark.parametrize("hw", [(32, 32), (20, 28)])
def test_eval_forward_matches_jax(pair_name, hw, request):
    jstate, tstate, _ = request.getfixturevalue(pair_name)
    x = _x((2, *hw, 1), seed=2)
    want = np.asarray(jstate.forward(jnp.asarray(x)))
    got = tstate.forward(_nchw(x))
    assert got.shape == (2, 3, 1, *hw) and got.dtype == torch.float32
    np.testing.assert_allclose(_to_jax_layout(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pair_name", PAIRS)
def test_train_forward_and_running_stats_match_jax(pair_name, request):
    jstate, tstate, variables = request.getfixturevalue(pair_name)
    model_name = "ResNet18" if pair_name == "resnet_pair" else "UNet"
    x = _x((4, 32, 32, 1), seed=4)
    want, updates = jstate.model.apply(jstate.variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
    tstate.model.train()
    try:
        got = tstate.model(_nchw(x))
        stats = {k: v.clone() for k, v in tstate.model.state_dict().items()
                 if "running" in k}
    finally:
        load_jax_variables(tstate.model, variables, model_name, "quantiles")
        tstate.model.eval()
    np.testing.assert_allclose(_to_jax_layout(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    moved = from_jax.state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])},
        model_name, "quantiles")
    assert set(stats) == {k for k in moved if "running" in k}
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), moved[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("pair_name", PAIRS)
def test_two_train_steps_losses_match_jax(pair_name, request):
    jstate, _, variables = request.getfixturevalue(pair_name)
    model_name = "ResNet18" if pair_name == "resnet_pair" else "UNet"
    cfg = RESNET if model_name == "ResNet18" else UNET
    r = np.random.RandomState(5)
    x, y = r.rand(4, 32, 32, 1).astype(np.float32), r.rand(4, 32, 32, 1).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32)
    tx = optax.adam(LR)
    body = jax.jit(jtrain._train_step_body(jstate.model, jheads.head_loss_pe_fn("quantiles"),
                                           cfg, tx))
    state = jtrain.TrainState(params=jstate.variables["params"],
                              batch_stats=jstate.variables["batch_stats"],
                              opt_state=tx.init(jstate.variables["params"]),
                              step=jnp.zeros((), jnp.int32))
    want = []
    for _ in range(2):
        state, loss, _ = body(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
        want.append(float(loss))

    trunk = tasm.build_trunk(cfg) if model_name == "ResNet18" else None
    if trunk is None:
        with torch.device("meta"):
            trunk = TUNet(bilinear=False, resize_backend="xla")
    tstate = tasm.add_uncertainty(trunk, cfg, device="cpu")
    load_jax_variables(tstate.model, variables, model_name, "quantiles")
    opt = torch.optim.Adam(tstate.model.parameters(), lr=LR)
    step = ttrain.make_train_step(tstate.model, theads.head_loss_pe_fn("quantiles"), cfg, opt)
    batch = (_nchw(x), _nchw(y), torch.from_numpy(mask))
    got = [float(step(*batch)) for _ in range(2)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-2)
    first = [p.grad for p in tstate.model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in first)


@pytest.mark.parametrize("utype", ["quantiles", "gaussian", "residual_magnitude", "softmax"])
def test_every_head_trains_on_resnet18(utype):
    cfg = dict(RESNET, uncertainty_type=utype, num_softmax=8, lr=LR)
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_x((2, 1, 16, 20), 6))
    out = state.forward(x)
    assert out.shape[0] == 2 and out.shape[-2:] == (16, 20) and torch.isfinite(out).all()
    opt = torch.optim.Adam(state.model.parameters(), lr=LR)
    step = ttrain.make_train_step(state.model, theads.head_loss_pe_fn(utype), cfg, opt)
    loss = step(x, torch.rand(2, 1, 16, 20), torch.ones(2))
    assert torch.isfinite(loss)
    grads = [p.grad for p in state.model.baseModel.parameters()]
    assert all(g is not None for g in grads) and any(g.abs().sum() > 0 for g in grads)


def test_resnet18_bf16_emits_f32_features():
    cfg = dict(RESNET, compute_dtype="bfloat16")
    state = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    assert state.model.baseModel.stem.weight.dtype == torch.float32
    feats = state.model.baseModel(torch.from_numpy(_x((2, 1, 16, 16), 7)))
    assert feats.dtype == torch.float32 and feats.shape == (2, 32, 16, 16)
