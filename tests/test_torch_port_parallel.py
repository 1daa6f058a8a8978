"""Port parity: data parallelism over two ranks (gloo, CPU) against one
process and against the JAX package's 2-device mesh.

Two OS processes, ranks of one gloo group on a free localhost port
(``_torch_port_ranks.start_ranks`` / ``wait_ranks``, at most 120 s,
children killed on a timeout), run the port's entry points over a
``parallel.mesh.Mesh`` on their shards; this process runs the same calls
without a mesh while they run (each process on one intra-op thread), and
the JAX package's ``make_train_step(..., mesh=data_parallel_mesh(2))``
and ``compute_risks_device`` on two of the 8 virtual CPU devices. The UNet is
the full-width one at 16x16 with the JAX package's init
(``interop/from_jax.state_dict_from_jax``); a full-width result leaves a
rank as a sample of 4096 elements of every tensor at seeded positions (all
of every bias and every BatchNorm vector), which both sides compare alike.

One SGD step (lr 1e-2, as ``tests/test_parallel.py``) on a batch of 8 with
one masked slot (7 real examples: the ranks hold 4 and 3, so the loss must
be normalised by the global mask count), and the running statistics after
it:

- the ranks hold the same gradients, parameters and statistics, bit for
  bit, in every case;
- float64, under ``xla`` and ``pallas_fused`` (and under ``remat`` conv and
  full): every gradient within 1e-9 relative L2 of the one-process f64 step
  (measured 2e-14; a conv bias that a BatchNorm follows has an exact
  gradient of 0 and is held beside the conv's weight gradient, as in
  ``test_torch_port_train.py``), and within 1e-6 of the JAX mesh step in
  f64 (that file's bar for the one-device steps), the loss to 1e-12 and
  1e-10, the running statistics to 1e-9;
- float32, under ``xla``, ``pallas`` and ``pallas_fused``: the parameters
  after the step and the running statistics within rtol 1e-4, atol 2e-6
  (``tests/test_parallel.py``'s bars) of the one-process step taken in
  f64, and the loss within 1e-5. The reference is the f64 step because the
  one-process f32 step is itself up to 4e-6 off it at 3 elements of one
  weight under ``pallas_fused`` (the fast variance Σy²/n − mean² rounds the
  two orders of summation apart, and a ReLU or pool kink amplifies it),
  while the 2-rank f32 step is within the bars everywhere. Against the JAX
  mesh step in f64: the loss within 1e-5, the whole gradient within 5e-2
  relative L2 and each running statistic within 1e-5
  (``test_torch_port_train.py``'s f32 bars);
- bfloat16 under ``xla`` and ``pallas_fused``, against the one-process
  bf16 step and the JAX mesh step in bf16 (``xla`` convs), by the tripwire
  of ``test_torch_port_bf16.py``: against the JAX mesh step in f64, the
  2-rank step's loss, whole-gradient (relative L2) and worst running
  statistic errors are at most twice the reference's own. That file's
  absolute bars (2e-3, 3e-1, 5e-3, measured at 128², batch 2) do not hold
  at 16², batch 8 even for the JAX bf16 step against f64 (measured 9.4e-4,
  1.3e-1 and 1.3e-2: bf16 rounding of BatchNorm statistics over 8 elements
  at the 1x1 level); the 2-rank steps measured 1.3e-3 to 1.7e-3, 1.4e-1 and
  1.5e-2, and 2e-4 to 2.7e-3, 6.6e-2 to 1.6e-1 and 4.9e-3 to 1.6e-2
  directly from the references.

Calibration, metrics and serving run a stand-in model, an exact elementwise
function of the input (``test_torch_port_router.py``'s), and the UNet: the
loss table (atol 1e-6; measured equal), λ̂ (equal) and
``compute_risks_device`` (1e-6 from the table's column means, and from the
JAX package's on the 2-device mesh) over the mesh against one process,
``eval_set_metrics`` with one seeded ``RandomState`` (equal: the draws come
in the one-device order), and ``predict_intervals`` / ``nested_sets`` with
padded batches (equal). ``train_net`` over the mesh at a batch of 7 (run as
8) for two epochs writes each checkpoint once and the log once; its first
epoch's loss is within 1e-4 of one process at batch 8, the later losses
within 5e-3, and the parameters within 2·lr per Adam step (4 steps) of it:
Adam moves a parameter by about lr·sign(g) at each step, and a gradient
element that is rounding noise (a conv bias before a BatchNorm) takes
either sign.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import time
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.calibration import rcps as jrcps
from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.parallel import mesh as jmesh
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.calibration import rcps as trcps
from im2im_uq_tpu_torch.interop.from_jax import state_dict_from_jax
from im2im_uq_tpu_torch.parallel import distributed as tdist
from im2im_uq_tpu_torch.parallel import mesh as tmesh
from im2im_uq_tpu_torch.scripts import infer as tinfer

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_port_ranks as ranks  # noqa: E402
from _torch_port_ranks import one_intra_op_thread  # noqa: E402,F401  (autouse)

pytestmark = pytest.mark.full  # spawns interpreters, compiles the JAX steps

F32_CASES = ["xla", "pallas", "pallas_fused"]
F64_CASES = ["xla_f64", "pallas_fused_f64", "xla_f64_remat_conv", "pallas_fused_f64_remat_full"]


def _batch():
    """8 synthetic 16x16 images, the last a wrapped copy of the first and
    masked, as ``iterate_batches(pad_mode="wrap")`` pads a batch of 7."""
    ds = SyntheticDataset(num_examples=7, image_size=16, seed=3)
    idx = list(range(7)) + [0]
    return (np.stack([ds[i][0] for i in idx]), np.stack([ds[i][1] for i in idx]),
            np.array([1.0] * 7 + [0.0], np.float32))


def _kspace_batch():
    """``_batch``'s targets and mask beside 8 raw k-space slices (24x20),
    the FastMRI hook's input."""
    _, y, mask = _batch()
    return np.random.RandomState(4).randn(8, 24, 20, 2), y, mask


def _jax_step(model, cfg: dict, variables: dict, batch: tuple, dtype) -> dict:
    """JAX's mesh step (SGD) on a 2-device mesh → the loss, samples of the
    gradients (from the update) and of the running statistics, port keys."""
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
    tx = optax.sgd(ranks.LR)
    mesh = jmesh.data_parallel_mesh(2)
    ts = jmesh.replicate_tree(mesh, jtrain.TrainState(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        step=jnp.zeros((), jnp.int32)))
    step = jtrain.make_train_step(model, jheads.head_loss_pe_fn("quantiles"), cfg, tx, mesh)
    new, loss = step(ts, *(np.asarray(a, dtype) for a in batch))
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),  # noqa: E731
                                              jax.device_get(tree))
    grads = jax.tree_util.tree_map(lambda a, b: (a - b) / ranks.LR, f64(variables["params"]),
                                   f64(new.params))
    sd = state_dict_from_jax({"params": grads, "batch_stats": f64(new.batch_stats)}, "UNet",
                             "quantiles")
    return {"loss": float(loss),
            "grads": ranks.sample({k: v for k, v in sd.items()
                                   if "running" not in k and "num_batches" not in k}),
            "stats": ranks.sample({k: v for k, v in sd.items() if "running" in k})}


def _jax_model(cfg: dict):
    return jasm.add_uncertainty(jasm.build_trunk(cfg), cfg, rng=jax.random.key(0),
                                example_input=jnp.zeros((1, 16, 16, 1)))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cfg = dict(DEFAULTS, **ranks.UNET)
    jstate = _jax_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    weights = state_dict_from_jax(variables, "UNet", "quantiles")
    batch = _batch()
    torch.save({"weights": weights, "batch": batch, "kspace_batch": _kspace_batch()},
               tmp / "inputs.pt")
    # the one-process references and the JAX steps are computed while the
    # ranks run
    started = time.monotonic()
    procs = ranks.start_ranks("all", tmp)
    try:
        one = {case: ranks.train_step_once(weights, dict(ranks.UNET, **extra), dtype, batch,
                                           None)
               for case, (extra, dtype) in ranks.TRAIN_CASES.items() if "remat" not in case}
        one[ranks.KSPACE_CASE] = ranks.train_step_once(weights, ranks.UNET, torch.float64,
                                                       _kspace_batch(), None,
                                                       ranks.kspace_preprocess())
        one_calibration = ranks.calibration_results(weights, None)
        with jax.enable_x64(True):
            jax64 = _jax_step(jstate.model, cfg, variables, batch, jnp.float64)
        bf16 = dict(cfg, compute_dtype="bfloat16")
        jbf16 = _jax_step(_jax_model(bf16).model, bf16, variables, batch, jnp.float32)
    finally:
        got = ranks.wait_ranks(procs, "all", tmp)
    return {"ranks": got, "one": one, "one_calibration": one_calibration, "jax64": jax64,
            "jbf16": jbf16, "weights": weights, "tmp": tmp,
            "rank_seconds": max(r["finished_at"] for r in got) - started}


def _feeds_batchnorm(name: str) -> bool:
    return re.search(r"double_conv\.[03]\.bias$", name) is not None


def _grad_errors(got: dict, want: dict) -> dict:
    """Relative L2 per gradient; a conv bias before a BatchNorm beside its
    conv's weight gradient."""
    out = {}
    for n, w in want.items():
        ref = want[n[:-len("bias")] + "weight"] if _feeds_batchnorm(n) else w
        out[n] = float((got[n] - w).norm() / ref.norm())
    return out


def _whole(got: dict, want: dict) -> float:
    return math.sqrt(sum(float((got[n] - w).square().sum()) for n, w in want.items())
                     / sum(float(w.square().sum()) for w in want.values()))


def _stats(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running" in k}


def _params(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running" not in k and "num_batches" not in k}


@pytest.mark.parametrize("case", list(ranks.TRAIN_CASES) + [ranks.KSPACE_CASE])
def test_ranks_hold_identical_replicas(dp, case, record_property):
    # the rank run's wall time, for the junit report: its limit is 120 s
    record_property("rank_seconds", dp["rank_seconds"])
    r0, r1 = dp["ranks"][0]["train"][case], dp["ranks"][1]["train"][case]
    assert r0["replicas_equal"] and r1["replicas_equal"]
    assert r0["loss"] == r1["loss"]


@pytest.mark.parametrize("case", F64_CASES)
def test_f64_step_matches_one_process_and_the_jax_mesh(dp, case):
    got = dp["ranks"][0]["train"][case]
    base = case.split("_remat")[0]
    one = dp["one"][base]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-12)
    assert max(_grad_errors(got["grads"], one["grads"]).values()) <= 1e-9
    for k, v in _stats(one["state"]).items():
        assert float((got["state"][k] - v).norm() / v.norm()) <= 1e-9, k
    want = dp["jax64"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-10)
    errs = _grad_errors(got["grads"], want["grads"])
    assert len(errs) == 80
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-6, (worst, errs[worst])
    for k, v in want["stats"].items():
        assert float((got["state"][k] - v).norm() / v.norm()) <= 1e-9, k


def test_fastmri_hook_step_matches_one_process(dp):
    """Each rank reconstructs its own 4 raw k-space slices inside the step:
    the 2-rank f64 step is the one-process step on all 8 (the f64 bars)."""
    got, one = dp["ranks"][0]["train"][ranks.KSPACE_CASE], dp["one"][ranks.KSPACE_CASE]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-12)
    errs = _grad_errors(got["grads"], one["grads"])
    assert len(errs) == 80 and max(errs.values()) <= 1e-9
    for k, v in _stats(one["state"]).items():
        assert float((got["state"][k] - v).norm() / v.norm()) <= 1e-9, k


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_step_matches_the_one_process_step_in_f64(dp, case):
    got = dp["ranks"][0]["train"][case]
    ref = dp["one"]["pallas_fused_f64" if case == "pallas_fused" else "xla_f64"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    for k, v in {**_params(ref["state"]), **_stats(ref["state"])}.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=k)


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_step_matches_the_jax_mesh_step_in_f64(dp, case):
    got, want = dp["ranks"][0]["train"][case], dp["jax64"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert _whole(got["grads"], want["grads"]) <= 5e-2
    for k, v in want["stats"].items():
        assert float((got["state"][k] - v).norm() / v.norm()) <= 1e-5, k


def _bf16_errors(got: dict, want: dict) -> tuple[float, float, float]:
    """(loss, whole gradient, worst running statistic) relative errors."""
    stats = want["stats"] if "stats" in want else _stats(want["state"])
    mine = got["stats"] if "stats" in got else got["state"]
    return (abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            _whole(got["grads"], want["grads"]),
            max(float((mine[k] - v).norm() / v.norm()) for k, v in stats.items()))


@pytest.mark.parametrize("case,ref", [("pallas_fused_bf16", "one_process"),
                                      ("xla_bf16", "one_process"), ("xla_bf16", "jax_mesh"),
                                      ("pallas_fused_bf16", "jax_mesh")])
def test_bf16_step_is_no_farther_from_f64_than_the_reference(dp, case, ref):
    got = dp["ranks"][0]["train"][case]
    want = dp["one"][case] if ref == "one_process" else dp["jbf16"]
    mine, theirs = _bf16_errors(got, dp["jax64"]), _bf16_errors(want, dp["jax64"])
    assert all(m <= 2 * t for m, t in zip(mine, theirs)), (mine, theirs)


@pytest.fixture(scope="module")
def one_calibration(dp):
    return dp["one_calibration"]


@pytest.mark.parametrize("model", ["standin", "unet"])
def test_calibration_table_and_lambda_hat_match_one_process(dp, one_calibration, model):
    for r in (0, 1):
        got, want = dp["ranks"][r]["calibration"][model], one_calibration[model]
        assert got["calib_table"].shape == want["calib_table"].shape == (10, 30)
        np.testing.assert_allclose(got["calib_table"], want["calib_table"], rtol=0, atol=1e-6)
        assert got["lhat"] == want["lhat"]
        np.testing.assert_allclose(got["risks"], want["risks"], rtol=0, atol=1e-6)
    got = dp["ranks"][0]["calibration"]["standin"]
    np.testing.assert_allclose(got["table_b5"], one_calibration["standin"]["table_b5"],
                               rtol=0, atol=1e-6)


class _JaxStandIn(fnn.Module):
    """``_torch_port_ranks.TorchStandIn`` in JAX, (B, 3, H, W, C)."""

    @fnn.compact
    def __call__(self, x, train=False):
        return jnp.stack([x - jnp.sqrt(jnp.abs(x) + 0.05), x, x + jnp.sqrt(jnp.abs(x) + 0.1)],
                         axis=1)


def test_compute_risks_device_matches_the_table_and_jax_on_a_mesh(dp):
    got = dp["ranks"][0]["calibration"]["standin"]["risks"]
    grid = trcps.lambda_grid(ranks.CALIB)
    shifted = grid - (grid[1] - grid[0])
    ds = SyntheticDataset(num_examples=10, image_size=16, seed=41)
    table = trcps.compute_loss_table(ranks.standin_state(), ds, shifted, batch_size=4)
    assert 0.0 < table.mean() < 1.0
    np.testing.assert_allclose(got, table.mean(axis=0), rtol=0, atol=1e-6)
    jstate = jasm.UQState(model=_JaxStandIn(), variables={}, params=ranks.CALIB)
    want = jrcps.compute_risks_device(jstate, ds, shifted, batch_size=4,
                                      mesh=jmesh.data_parallel_mesh(2), method="direct")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    unet = dp["ranks"][0]["calibration"]["unet"]
    assert unet["risks"].shape == (30,) and np.isfinite(unet["risks"]).all()


def test_set_metrics_match_one_process_with_the_same_rng(dp, one_calibration):
    want = one_calibration["standin"]["metrics"]
    for r in (0, 1):
        got = dp["ranks"][r]["calibration"]["standin"]["metrics"]
        assert sorted(got) == sorted(want)
        assert 0.0 < want["risk"] < 1.0
        for key, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w), err_msg=key)
        assert (dp["ranks"][r]["calibration"]["standin"]["risk_only"]
                == one_calibration["standin"]["risk_only"])


def test_served_intervals_match_one_process(dp, one_calibration):
    want = one_calibration["unet"]
    for r in (0, 1):
        got = dp["ranks"][r]["calibration"]["unet"]
        for key in ("lower", "prediction", "upper"):
            assert got["served"][key].shape == (5, 16, 16, 1)
            np.testing.assert_array_equal(got["served"][key], want["served"][key], err_msg=key)
        for g, w in zip(got["sets_odd"], want["sets_odd"]):
            assert g.shape == (3, 1, 16, 16)
            np.testing.assert_array_equal(g, w)


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_net_over_the_mesh(dp, tmp_path):
    run = dp["tmp"] / "train_net"
    assert sorted(os.listdir(run / "ckpt")) == [
        f"CP_epoch{e}_synthetic_quantiles_7_0.001_standard_min-max.pt" for e in (1, 2)]
    one = ranks.train_net_results(dp["weights"], tmp_path, None, 8)
    got, want = _records(run / "log" / "metrics.jsonl"), _records(tmp_path / "log" / "metrics.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]  # one writer, the same records
    losses = [(r, k) for r in range(len(want)) for k in ("train_loss", "val_loss") if k in want[r]]
    assert len(losses) == 4
    for i, (r, k) in enumerate(losses):
        rtol = 1e-4 if i == 0 else 5e-3
        assert got[r][k] == pytest.approx(want[r][k], rel=rtol), (r, k)
    bound = 2 * 1e-3 * 4
    for k, v in _params(one["state"]).items():
        assert float((dp["ranks"][0]["train_net"]["state"][k] - v).abs().max()) <= bound, k


# ------------------------------------------------- host logic, no ranks


def test_mesh_of_one_rank_is_the_one_device_path():
    mesh = tmesh.data_parallel_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert not tmesh.spans(mesh) and not tmesh.spans(None)
    a = np.arange(6)
    assert tmesh.put_batch(mesh, a)[0] is a and tmesh.fetch(mesh, torch.ones(2)).shape == (2,)
    assert tmesh.mesh_batch_size(7, mesh) == 7


def test_put_batch_takes_each_ranks_contiguous_slice():
    a = np.arange(8)
    for rank in (0, 1):
        mesh = tmesh.Mesh(group=None, size=2, rank=rank, device=torch.device("cpu"))
        np.testing.assert_array_equal(tmesh.put_batch(mesh, a)[0], a[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(tmesh.shard_batch(mesh, torch.from_numpy(a)).numpy(),
                                      a[4 * rank:4 * rank + 4])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.put_batch(tmesh.Mesh(None, 2, 0, torch.device("cpu")), np.arange(7))


@pytest.mark.parametrize("bad", [object(), "data", 2])
def test_a_non_mesh_raises_type_error(bad):
    state = ranks.standin_state()
    ds = SyntheticDataset(num_examples=2, image_size=8, seed=0)
    with pytest.raises(TypeError, match="Mesh"):
        trcps.compute_loss_table(state, ds, np.array([1.0]), mesh=bad)
    with pytest.raises(TypeError, match="Mesh"):
        state.nested_sets(torch.zeros((1, 1, 8, 8)), lam=1.0, mesh=bad)
    with pytest.raises(TypeError, match="Mesh"):
        tinfer.predict_intervals(state, np.zeros((1, 8, 8, 1), np.float32), lam=1.0, mesh=bad)


def test_spawn_per_device_kills_the_ranks_on_a_timeout_and_passes_failures_on():
    # a rank that sleeps past the limit: every rank is killed, exit 124
    assert tdist.spawn_per_device(["-m", "timeit", "-n", "1", "import time; time.sleep(60)"], 2,
                                  timeout=3) == 124
    # a rank that fails (bad arguments): its exit code
    assert tdist.spawn_per_device(["-m", "im2im_uq_tpu_torch.scripts.router", "--bogus"], 2,
                                  timeout=60) == 2


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tdist.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert tdist.process_shard_info() == (0, 1) and tdist.global_mesh() is None
    assert not tdist.launched()
    assert tdist.join_or_spawn("im2im_uq_tpu_torch.scripts.router", [], "cpu") == (None, None)


def test_an_indexed_cuda_device_runs_in_this_process(monkeypatch):
    """Over four visible GPUs, plain ``cuda`` spreads over all of them and
    ``cuda:N`` stays on one, in this process (as ``chip_smoke.py``'s
    single-process phases pass it): no worker is started."""
    import chip_smoke

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tdist, "spawn_per_device",
                        lambda *a, **kw: pytest.fail("a worker was started"))
    assert tdist.visible_devices("cuda") == 4
    assert tdist.visible_devices(chip_smoke.DEVICE) == 1
    assert tdist.visible_devices(torch.device("cuda", 3)) == 1
    assert tdist.visible_devices("cpu") == 1
    assert tdist.join_or_spawn("im2im_uq_tpu_torch.scripts.router", [],
                               chip_smoke.DEVICE) == (None, None)
