"""Port parity: ``make_train_multistep`` on the CPU.

On the CPU the port's multistep is a plain loop of ``make_train_step``'s
step, so it equals N sequential steps bit for bit (loss, weights, BatchNorm
statistics, Adam's state). Against the JAX ``make_train_multistep`` (its
``fori_loop``) on the same init and batch, K = 3 steps at 32²:

- under SGD in float64 on both sides (``jax.enable_x64``), which pins the
  semantics: the last loss within rtol 1e-12 (measured equal), the whole
  update (every parameter's change from the init) within 1e-9 relative L2
  (measured 2e-14), and every parameter and running statistic within rtol
  1e-9, atol 1e-12 (measured 9e-16 at most). In f32 the two sides'
  per-tensor gradients differ by a few percent at ReLU and max-pool kinks
  (``tests/test_torch_port_train.py``), so f32 parameters are not compared
  per tensor there;
- under Adam in f32: the last loss within rtol 2e-2, the bar of
  ``tests/test_torch_port_train.py`` for f32 steps (measured 1.4e-3), and
  the parameters within K·2e-3, ``tests/test_multistep.py``'s bar (a
  gradient near zero can flip Adam's update, ±lr a step; measured 5.7e-3).

Over a mesh of two gloo ranks (``_torch_port_ranks``' ``multistep``
worker, at most 120 s) the port's multistep is a plain loop of the mesh
step: the UNet at 16² from the JAX package's init, a global batch of 8 with
one example masked (the ranks hold 4 real examples and 3), K = 3 steps in
each case (``xla`` and ``pallas_fused`` in f64 under SGD, ``xla`` in f32
under Adam):

- on each rank it equals 3 sequential mesh ``make_train_step`` calls bit
  for bit (the loss, the state dict, the optimizer's state), and the ranks
  hold the same bits;
- in f64 the last loss is within rtol 1e-12 of the port's one-process
  multistep on the whole batch and of the JAX package's
  ``make_train_multistep(mesh=data_parallel_mesh(2))`` (measured equal),
  and every parameter and running statistic within rtol 1e-9, atol 1e-12
  of both (a sample of 4096 elements of each tensor,
  ``_torch_port_ranks.sample``; measured at most 1e-15 apart from one
  process and 3e-15 from JAX, 1.0e-12 relative where |value| > 1e-3): the
  one-rank bars hold over the mesh's order of sums;
- in f32 under Adam, against the JAX mesh multistep: the last loss within
  rtol 2e-2 and the parameters within K·2e-3, the one-rank bars above
  (measured 2.8e-3 and 5.6e-3);
- a mesh of CUDA ranks under gloo is refused with a ``ValueError`` that
  names NCCL (gloo's collectives on CUDA tensors cannot be captured).

The CUDA graph is the card's (``chip_smoke.py``'s ``multistep`` phase, and
over NCCL ranks its ``dp`` phase's ``dp_multistep`` case).
"""

from __future__ import annotations

import sys
from pathlib import Path

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
from im2im_uq_tpu.parallel import mesh as jmesh
from im2im_uq_tpu.training import train as jtrain

from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables, state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.models import heads as theads
from im2im_uq_tpu_torch.parallel.mesh import Mesh
from im2im_uq_tpu_torch.training import train as ttrain

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_port_ranks as ranks  # noqa: E402
from _torch_port_ranks import one_intra_op_thread  # noqa: E402,F401  (autouse)

CFG = {"model": "UNet", "uncertainty_type": "quantiles", "q_lo": 0.05, "q_hi": 0.95,
       "q_lo_weight": 1.0, "q_hi_weight": 1.0, "mse_weight": 1.0, "resize_backend": "xla",
       "lane_pack": False}
K = 3


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 32, 32, 1).astype(np.float32)
    y = rng.randn(4, 32, 32, 1).astype(np.float32)
    return x, y, np.array([1, 1, 1, 0], np.float32)


def _torch_batch():
    x, y, mask = _batch()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return t(x), t(y), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def jax_init():
    st = jasm.add_uncertainty(jasm.build_trunk(CFG), dict(CFG), rng=jax.random.key(0),
                              example_input=jnp.zeros((1, 32, 32, 1)))
    return st.model, jax.tree_util.tree_map(np.asarray, jax.device_get(dict(st.variables)))


def _port(variables=None, seed=0):
    if variables is None:
        return tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                                    generator=torch.Generator().manual_seed(seed), device="cpu")
    st = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(st.model, variables, "UNet", "quantiles")
    return st


def _everything(model, opt) -> dict:
    out = {k: v.clone() for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"adam.{i}.{n}": v.clone() for n, v in st.items()})
    return out


@pytest.mark.parametrize("watch", [False, True])
def test_multistep_equals_sequential_steps_bit_for_bit(watch):
    cfg = dict(CFG, watch_gradients=watch)
    batch = _torch_batch()
    a = _port()
    opt_a = torch.optim.Adam(a.model.parameters(), lr=1e-3)
    step = ttrain.make_train_step(a.model, theads.head_loss_pe_fn("quantiles"), cfg, opt_a)
    for _ in range(K):
        out = step(*batch)
    seq_loss = out[0] if watch else out
    b = _port()
    opt_b = torch.optim.Adam(b.model.parameters(), lr=1e-3)
    loop = ttrain.make_train_multistep(b.model, theads.head_loss_pe_fn("quantiles"), cfg, opt_b,
                                       num_steps=K)
    loss = loop(*batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert torch.equal(loss, seq_loss)
    want, got = _everything(a.model, opt_a), _everything(b.model, opt_b)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(opt_b.state_dict()["state"][0]["step"]) == K


def _run_both(jax_init, jax_tx, torch_opt, f64: bool = False):
    """K steps of the JAX multistep and of the port's from the same init →
    (JAX loss, JAX step count, JAX state dict, port loss, port state dict),
    in float64 on both sides when ``f64``."""
    model, variables = jax_init
    jdtype, tdtype = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    with jax.enable_x64(f64):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), variables)
        ts = jtrain.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                               opt_state=jax_tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
        loop = jtrain.make_train_multistep(model, jheads.head_loss_pe_fn("quantiles"), CFG,
                                           jax_tx, num_steps=K)
        ts, jloss = loop(ts, *(jnp.asarray(a, jdtype) for a in _batch()))
        tree = jax.tree_util.tree_map(np.asarray, {"params": ts.params,
                                                   "batch_stats": ts.batch_stats})
        jloss, jsteps = float(jloss), int(ts.step)
    want = export_state_dict(tree, "UNet", "quantiles")
    st = _port(variables)
    st.model.to(tdtype)
    opt = torch_opt(st.model.parameters())
    tloop = ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt,
                                        num_steps=K)
    tloss = tloop(*(t.to(tdtype) for t in _torch_batch()))
    return jloss, jsteps, want, float(tloss), st.model.state_dict()


def test_multistep_matches_jax_under_sgd_in_f64(jax_init):
    jloss, jsteps, want, tloss, got = _run_both(
        jax_init, optax.sgd(1e-2), lambda p: torch.optim.SGD(p, lr=1e-2), f64=True)
    assert jsteps == K
    assert tloss == pytest.approx(jloss, rel=1e-12)
    init = _port(jax_init[1]).model.state_dict()
    params = [k for k in want if "running" not in k and not k.endswith("num_batches_tracked")]
    delta_got = torch.cat([(got[k] - init[k].double()).flatten() for k in params])
    delta_want = torch.cat([(want[k].double() - init[k].double()).flatten() for k in params])
    assert ((delta_got - delta_want).norm() / delta_want.norm()).item() < 1e-9
    for k in want:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-9, atol=1e-12,
                                       err_msg=k)


def test_multistep_matches_jax_adam_semantics(jax_init):
    jloss, jsteps, want, tloss, got = _run_both(
        jax_init, optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3))
    assert jsteps == K
    assert tloss == pytest.approx(jloss, rel=2e-2)
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=K * 2e-3, err_msg=k)


def test_multistep_refuses_a_mesh_of_several_ranks_and_zero_steps():
    st = _port()
    opt = torch.optim.Adam(st.model.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="num_steps"):
        ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt, 0)
    one = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    loop = ttrain.make_train_multistep(st.model, theads.head_loss_pe_fn("quantiles"), CFG, opt,
                                       1, mesh=one)
    assert torch.isfinite(loop(*_torch_batch()))


# ------------------------------------------------- over two gloo ranks

MESH_CASES = list(ranks.MULTISTEP_CASES)
F64_MESH_CASES = [c for c, (_, dtype, _) in ranks.MULTISTEP_CASES.items()
                  if dtype == torch.float64]


def _mesh_batch():
    """8 synthetic 16x16 images, the last a wrapped copy of the first and
    masked, as ``iterate_batches(pad_mode="wrap")`` pads a batch of 7."""
    ds = SyntheticDataset(num_examples=7, image_size=16, seed=3)
    idx = list(range(7)) + [0]
    return (np.stack([ds[i][0] for i in idx]), np.stack([ds[i][1] for i in idx]),
            np.array([1.0] * 7 + [0.0], np.float32))


def _jax_mesh_multistep(model, variables: dict, batch: tuple, tx, f64: bool) -> dict:
    """K steps of the JAX ``make_train_multistep`` on a 2-device mesh → the
    last loss, the step count, and a sample of the state dict, port keys."""
    dtype = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
        mesh = jmesh.data_parallel_mesh(2)
        ts = jmesh.replicate_tree(mesh, jtrain.TrainState(
            params=v["params"], batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            step=jnp.zeros((), jnp.int32)))
        loop = jtrain.make_train_multistep(model, jheads.head_loss_pe_fn("quantiles"), CFG, tx,
                                           num_steps=K, mesh=mesh)
        ts, loss = loop(ts, *(np.asarray(a, dtype) for a in batch))
        tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
            {"params": ts.params, "batch_stats": ts.batch_stats}))
        return {"loss": float(loss), "steps": int(ts.step),
                "state": ranks.sample(export_state_dict(tree, "UNet", "quantiles"))}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The ranks' results; meanwhile, in this process, the one-process f64
    multisteps on the whole batch and the JAX mesh multisteps."""
    assert ranks.MULTISTEP_K == K and ranks.UNET == CFG
    tmp = tmp_path_factory.mktemp("multistep")
    jstate = jasm.add_uncertainty(jasm.build_trunk(CFG), dict(CFG), rng=jax.random.key(0),
                                  example_input=jnp.zeros((1, 16, 16, 1)))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    weights = state_dict_from_jax(variables, "UNet", "quantiles")
    batch = _mesh_batch()
    torch.save({"weights": weights, "batch": batch}, tmp / "inputs.pt")
    procs = ranks.start_ranks("multistep", tmp)
    try:
        one = {}
        for case in F64_MESH_CASES:
            loss, state = ranks.multistep_run(weights, case, batch, None)
            one[case] = {"loss": float(loss), "state": ranks.sample(state)}
        jax64 = _jax_mesh_multistep(jstate.model, variables, batch, optax.sgd(ranks.LR), True)
        jax32 = _jax_mesh_multistep(jstate.model, variables, batch, optax.adam(1e-3), False)
    finally:
        got = ranks.wait_ranks(procs, "multistep", tmp, ranks.MULTISTEP_TIMEOUT)
    return {"ranks": got, "one": one, "jax64": jax64, "jax32": jax32,
            "init": ranks.sample(weights)}


def _model_tensors(state: dict) -> dict:
    return {k: v for k, v in state.items()
            if not k.startswith("opt.") and not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_multistep_equals_sequential_mesh_steps_bit_for_bit(mesh_runs, case):
    for r in (0, 1):
        got = mesh_runs["ranks"][r][case]
        assert got["equal_to_sequential"], r
        assert got["loss_dtype"] == "torch.float32"


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_multistep_ranks_hold_the_same_bits(mesh_runs, case):
    r0, r1 = mesh_runs["ranks"][0][case], mesh_runs["ranks"][1][case]
    assert r0["replicas_equal"] and r1["replicas_equal"]
    assert r0["loss"] == r1["loss"]
    assert r0["state"].keys() == r1["state"].keys()
    assert all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items())


def _within_f64_bars(got: dict, want: dict) -> None:
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-12)
    tensors = _model_tensors(want["state"])
    assert len(tensors) == 116  # 80 parameters, 18 BatchNorms' 2 running statistics
    for k, v in tensors.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-9, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("case", F64_MESH_CASES)
def test_mesh_multistep_matches_the_one_process_multistep_in_f64(mesh_runs, case):
    _within_f64_bars(mesh_runs["ranks"][0][case], mesh_runs["one"][case])


@pytest.mark.parametrize("case", F64_MESH_CASES)
def test_mesh_multistep_matches_the_jax_mesh_multistep_in_f64(mesh_runs, case):
    assert mesh_runs["jax64"]["steps"] == K
    got, want = mesh_runs["ranks"][0][case], mesh_runs["jax64"]
    _within_f64_bars(got, want)
    # the steps moved the parameters: the bars are not met by the init
    init = _model_tensors(mesh_runs["init"])
    moved = max(float((want["state"][k] - v.double()).abs().max()) for k, v in init.items())
    assert moved > 1e-4


def test_mesh_multistep_adam_f32_matches_the_jax_mesh_multistep(mesh_runs):
    got, want = mesh_runs["ranks"][0]["xla_f32_adam"], mesh_runs["jax32"]
    assert want["steps"] == K
    assert got["loss"] == pytest.approx(want["loss"], rel=2e-2)
    for k, v in _model_tensors(want["state"]).items():
        if "running" in k:
            continue
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), atol=K * 2e-3, err_msg=k)


def test_mesh_multistep_refuses_cuda_ranks_under_gloo(mesh_runs):
    for r in (0, 1):
        msg = mesh_runs["ranks"][r]["gloo_on_cuda"]
        assert msg is not None and "NCCL" in msg and "gloo" in msg


def test_cached_tables_made_under_inference_mode_serve_autograd():
    """The plain versions' constant tables are kept on the device per shape
    (a CUDA graph's capture may copy nothing from the host); one first made
    by an eval forward under ``torch.inference_mode`` still serves a train
    step's autograd, a second call takes the same tensors, and a table made
    while ``torch.export`` traces is not kept (it is a fake tensor there)."""
    from im2im_uq_tpu_torch.ops import constants, losses, resize, upsample

    constants.clear()
    x = torch.randn(2, 3, 5, 7)
    with torch.inference_mode():
        upsample.upsample2x_plain(x)
        resize.resize_bilinear_align_corners(x, (9, 4))
        losses.bucketize_targets(torch.rand(4), 6)
    xg = x.clone().requires_grad_(True)
    y = upsample.upsample2x_plain(xg).sum() + resize.resize_bilinear_align_corners(xg, (9, 4)).sum()
    y.backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    assert losses.bucketize_targets(torch.rand(4), 6).dtype == torch.int64
    first = upsample._device_tables(upsample.phase_weights, 5, x.device, x.dtype)
    assert upsample._device_tables(upsample.phase_weights, 5, x.device, x.dtype) is first
    assert not any(t.is_inference() for t in first)
    ep = torch.export.export(_Upsample(), (torch.randn(1, 2, 6, 3),))
    assert not any(type(t) is not torch.Tensor for v in constants._TABLES.values() for t in v)
    got = ep.module()(x[:1, :2, :5, :3].repeat(1, 1, 1, 1).new_ones(1, 2, 6, 3))
    want = upsample.upsample2x_plain(torch.ones(1, 2, 6, 3))
    assert torch.equal(got, want)


class _Upsample(torch.nn.Module):
    def forward(self, x):
        from im2im_uq_tpu_torch.ops import upsample

        return upsample.upsample2x_plain(x)
