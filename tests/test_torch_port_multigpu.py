"""Port parity: the multi-GPU API beyond data-parallel training, on two
gloo ranks (CPU) against one process and against the JAX package.

One launch of two gloo ranks (``_torch_port_ranks``, worker ``multigpu``,
at most 120 s) serves all the tests here. The one-process references come
from the same worker in a third process, over a mesh of one rank (the
one-process path of every call), started beside them with the ranks'
thread settings: the CPU convs pick their algorithm, and so their bits, by
the threads a process starts with. This process meanwhile runs the JAX
references.

- The data-parallel serving artifact (``export_serving --n-devices 2``,
  global batch 4): through ``predict_intervals`` on 5 images (the tail
  padded) and through ``infer.main --artifact`` in the ranks, its intervals
  are bit for bit those of the one-process artifact of the same model.
- Height-sharded serving (``parallel/spatial.spatial_nested_sets``): the
  UNet with the ``quantiles`` head at 80x48 (the 16-row blocks split 48|32)
  and 40x32 (16|24: the last rank takes 8 rows left over, and ``Up`` pads)
  under ``conv_backend`` xla, pallas and pallas_fused, at 80x48 with
  ``resize_backend: pallas`` (K1f over the gathered height), WNet at 40x32,
  and 24x16, where rank 1's share is empty at the deepest level: each
  within rtol 2e-5, atol 1e-6 (``tests/test_parallel.py``'s bars for JAX's
  own sharded forward) of the port's one-process ``nested_sets`` on the
  same weights, the same on both ranks; at 40x32 under xla also within
  those bars of the JAX package's one-device ``nested_sets`` (JAX's init,
  random BatchNorm statistics, carried across by ``interop/from_jax``).
- Multi-seed training (``training/multiseed.py``), 4 seeds, 2 a rank, two
  Adam steps: each replica bit for bit the one-process plain step of its
  seed, the seeds' losses all different, no collective during the steps,
  and ``replica_state`` giving every rank the replica (which serves). From
  JAX's init of each seed (``im2im_uq_tpu.training.multiseed
  .init_multiseed_states``, carried across) the replicas' losses are within
  ``tests/test_torch_port_train.py``'s bars of JAX's plain train step of
  that seed, which is JAX's multi-seed replica by construction
  (``multiseed.py:67-70``): the first step's to rtol 1e-5, both to 2e-2.
- ``UpNoSkip`` by 3 on rows split over the ranks, against one process.
- In this process: the row split (empty shares included), the windowed
  global taps against ``_tap_tables`` over the whole height, the binding of
  a data-parallel artifact in a larger group, and the guards.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from im2im_uq_tpu.data.synthetic import SyntheticDataset
from im2im_uq_tpu.models import assembly as jasm
from im2im_uq_tpu.models import heads as jheads
from im2im_uq_tpu.training import multiseed as jmultiseed
from im2im_uq_tpu.training import train as jtrain
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.interop.from_jax import state_dict_from_jax
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.ops import resize as tresize
from im2im_uq_tpu_torch.parallel import mesh as tmesh
from im2im_uq_tpu_torch.parallel import spatial
from im2im_uq_tpu_torch.scripts import export_serving as texport
from im2im_uq_tpu_torch.scripts import infer as tinfer
from im2im_uq_tpu_torch.training import multiseed

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_port_ranks as ranks  # noqa: E402
from _torch_port_ranks import one_intra_op_thread  # noqa: E402,F401  (autouse)

pytestmark = pytest.mark.full  # spawns interpreters, compiles JAX programs

CFG = dict(DEFAULTS, **ranks.UNET, lr=ranks.MULTISEED_LR)
RTOL, ATOL = 2e-5, 1e-6
LHAT = 1.5


def _random_stats(tree, rng: np.random.RandomState):
    """JAX batch_stats with random running means and variances."""
    if "mean" in tree and "var" in tree:
        return {"mean": rng.uniform(-0.3, 0.3, tree["mean"].shape).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in tree.items()}


def _batches():
    """Two batches of four synthetic 16x16 images."""
    out = []
    for k in range(2):
        ds = SyntheticDataset(num_examples=4, image_size=16, seed=10 + k)
        out.append((np.stack([ds[i][0] for i in range(4)]), np.stack([ds[i][1] for i in range(4)]),
                    np.ones(4, np.float32)))
    return out


def _wnet_weights() -> dict:
    cfg = dict(ranks.UNET, model="WNet")
    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu",
                              generator=torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in st.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return st.model.state_dict()


def _jax_plain_steps(jstate, jvars: dict, batches) -> dict:
    """JAX's plain train step (the body ``make_train_step`` jits), Adam, from
    each seed's init → the losses."""
    tx = optax.adam(CFG["lr"])
    step = jax.jit(jtrain._train_step_body(jstate.model, jheads.head_loss_pe_fn("quantiles"),
                                           CFG, tx))
    out = {}
    for s, v in jvars.items():
        state = jtrain.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                                  opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
        losses = []
        for b in batches:
            state, loss, _ = step(state, *(jnp.asarray(a) for a in b))
            losses.append(float(loss))
        out[s] = losses
    return out


@pytest.fixture(scope="module")
def mg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multigpu")
    jstate = jasm.add_uncertainty(jasm.build_trunk(CFG), CFG)
    stacked = jmultiseed.init_multiseed_states(jstate, list(ranks.SEEDS), optax.adam(CFG["lr"]),
                                               jnp.zeros((1, 16, 16, 1)))
    jvars = {s: jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]),
                                       {"params": stacked.params,
                                        "batch_stats": stacked.batch_stats})
             for i, s in enumerate(ranks.SEEDS)}
    spatial_vars = dict(jvars[0], batch_stats=_random_stats(jvars[0]["batch_stats"],
                                                            np.random.RandomState(7)))
    weights = {"UNet": state_dict_from_jax(spatial_vars, "UNet", "quantiles"),
               "WNet": _wnet_weights()}
    rng = np.random.RandomState(3)
    spatial_x = {name: rng.randn(1, 2 if "wnet" in name else 1, h, w).astype(np.float32)
                 for name, (h, w, _) in ranks.SPATIAL_CASES.items()}
    serve = rng.rand(5, 32, 32, 1).astype(np.float32)
    np.save(tmp / "serve.npy", serve)
    batches = _batches()
    torch.save({"weights": weights, "spatial_x": spatial_x, "serve": serve, "batches": batches,
                "upnoskip_x": rng.randn(1, 16, 40, 32).astype(np.float32),
                "jax_seed_weights": [state_dict_from_jax(jvars[s], "UNet", "quantiles")
                                     for s in ranks.SEEDS]}, tmp / "inputs.pt")
    served = tasm.add_uncertainty(tasm.build_trunk(ranks.UNET), ranks.UNET, device="cpu")
    served.model.load_state_dict(weights["UNet"])
    served = served.replace(lhat=LHAT)
    kw = dict(batch_size=4, height=32, width=32)
    meta2 = texport.export_serving_artifact(served, str(tmp / "art2.pt2"), n_devices=2, **kw)
    texport.export_serving_artifact(served, str(tmp / "art1.pt2"), **kw)
    procs = ranks.start_ranks("multigpu", tmp), ranks.start_ranks("multigpu_one", tmp, n=1)
    try:
        x40 = spatial_x["40x32_xla"].transpose(0, 2, 3, 1)
        jsets = jstate.replace(variables=spatial_vars).nested_sets(jnp.asarray(x40),
                                                                    lam=ranks.SPATIAL_LAM)
        jax_sets = [np.asarray(t).transpose(0, 3, 1, 2) for t in jsets]
        jax_losses = _jax_plain_steps(jstate, jvars, batches)
    finally:
        got = ranks.wait_ranks(procs[0], "multigpu", tmp)
        (one,) = ranks.wait_ranks(procs[1], "multigpu_one", tmp)
    return {"ranks": got, "one": one, "jax_sets": jax_sets, "jax_losses": jax_losses,
            "meta2": meta2, "tmp": tmp}


# ------------------------------------------------ the data-parallel artifact


def test_dp_artifact_matches_the_one_process_artifact_bit_for_bit(mg):
    assert mg["meta2"]["n_devices"] == 2 and mg["meta2"]["batch_size"] == 4
    want = mg["one"]["artifact"]["served"]
    for r, res in enumerate(mg["ranks"]):
        assert res["artifact"]["ranks"] == (2, r)
        got = res["artifact"]["served"]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == (5, 32, 32, 1)
            np.testing.assert_array_equal(got[k], want[k])


def test_infer_cli_serves_a_dp_artifact_over_its_ranks(mg):
    assert [res["artifact"]["cli_rc"] for res in mg["ranks"]] == [0, 0]
    assert mg["one"]["artifact"]["cli_rc"] == 0
    got, want = ({k: z[k] for k in z.files} for z in (
        np.load(mg["tmp"] / d / "serve_intervals.npz") for d in ("served", "served_one")))
    assert float(got.pop("lam")) == float(want.pop("lam")) == LHAT
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    summary = json.loads((mg["tmp"] / "served" / "inference_summary.json").read_text())
    assert (summary["images"], summary["lam"]) == (5, LHAT)


# ----------------------------------------------------- height-sharded serving


@pytest.mark.parametrize("case", list(ranks.SPATIAL_CASES))
def test_spatial_sets_match_one_process(mg, case):
    want = mg["one"]["spatial"][case]
    h, w, _ = ranks.SPATIAL_CASES[case]
    got0, got1 = (res["spatial"][case] for res in mg["ranks"])
    for a, b, c in zip(got0, got1, want):
        assert a.shape == (1, 1, h, w)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


def test_spatial_upnoskip_by_three_matches_one_process(mg):
    """``UpNoSkip`` (no trunk uses it) resizes a rank's rows by any integer
    factor with the same windowed taps, and records its output's layout."""
    want = mg["one"]["upnoskip"]
    assert want.shape == (1, 8, 120, 96)
    for res in mg["ranks"]:
        np.testing.assert_allclose(res["upnoskip"], want, rtol=RTOL, atol=ATOL)


def test_spatial_sets_match_jax_at_40x32(mg):
    got = mg["ranks"][0]["spatial"]["40x32_xla"]
    for a, c in zip(got, mg["jax_sets"]):
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- multi-seed training


def test_multiseed_replicas_match_one_process_runs_bit_for_bit(mg):
    seen = []
    for res in mg["ranks"]:
        run = res["multiseed"]
        seen += list(run["seeds"])
        for i, s in enumerate(run["seeds"]):
            assert [losses[i] for losses in run["losses"]] == _one_losses(mg, s)
            for k, v in mg["one"]["multiseed"]["states"][s].items():
                assert torch.equal(run["states"][i][k], v), (s, k)
    assert seen == list(ranks.SEEDS) == list(mg["one"]["multiseed"]["seeds"])


def _one_losses(mg, s: int) -> list:
    """Seed s's losses in the one-process run."""
    return [losses[s] for losses in mg["one"]["multiseed"]["losses"]]


def test_multiseed_seeds_give_different_losses(mg):
    first = [_one_losses(mg, s)[0] for s in ranks.SEEDS]
    assert len(set(first)) == len(ranks.SEEDS)
    got = [x for res in mg["ranks"] for x in res["multiseed"]["losses"][0]]
    assert got == first


def test_multiseed_steps_issue_no_collective(mg):
    for res in mg["ranks"]:
        assert res["multiseed"]["collectives"] == []
        assert res["multiseed_jax_init"]["collectives"] == []


def test_replica_state_serves_every_replica_on_every_rank(mg):
    for res in mg["ranks"]:
        for s, sd in zip(ranks.SEEDS, res["multiseed"]["replicas"]):
            for k, v in mg["one"]["multiseed"]["states"][s].items():
                assert torch.equal(sd[k], v), (s, k)
        for a, c in zip(res["multiseed"]["replica3_sets"],
                        mg["one"]["multiseed"]["replica3_sets"]):
            assert a.shape == (1, 1, 32, 32)
            np.testing.assert_array_equal(a, c)


def test_multiseed_from_jax_init_matches_jax_plain_steps(mg):
    for res in mg["ranks"]:
        run = res["multiseed_jax_init"]
        for i, s in enumerate(run["seeds"]):
            got = [losses[i] for losses in run["losses"]]
            want = mg["jax_losses"][s]
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            np.testing.assert_allclose(got, want, rtol=2e-2)


# ------------------------------------------------------------ in this process


@pytest.mark.parametrize("height, n, want", [
    (80, 2, ((0, 48), (48, 80))),
    (40, 2, ((0, 16), (16, 40))),
    (648, 2, ((0, 320), (320, 648))),
    (24, 2, ((0, 16), (16, 24))),
    (40, 4, ((0, 16), (16, 32), (32, 32), (32, 40))),
    (8, 3, ((0, 0), (0, 0), (0, 8))),
])
def test_row_spans_split_the_blocks_and_leave_the_rest_to_the_last_rank(height, n, want):
    got = spatial.row_spans(height, n)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert all(stop % 16 == 0 for _, stop in got[:-1])


def test_neighbours_skip_empty_shares():
    rows = spatial.Rows(40, ((0, 16), (16, 32), (32, 32), (32, 40)))
    assert [rows.neighbours(r) for r in range(4)] == [(None, 1), (0, 3), (None, None), (1, None)]
    deepest = spatial.Rows(1, ((0, 1), (1, 1)))  # 24 rows over two ranks, four pools down
    assert [deepest.neighbours(r) for r in range(2)] == [(None, None), (None, None)]


def _matrix(i0, i1, frac, n_in: int) -> np.ndarray:
    m = np.zeros((len(i0), n_in))
    for u, (a, b, f) in enumerate(zip(i0, i1, frac)):
        m[u, a] += 1.0 - f
        m[u, b] += f
    return m


@pytest.mark.parametrize("n_in, n_out", [(5, 10), (20, 40), (1, 2), (7, 21)])
def test_windowed_global_taps_match_the_whole_height(n_in, n_out):
    whole = _matrix(*tresize._tap_tables(n_in, n_out), n_in)
    np.testing.assert_allclose(_matrix(*tresize.axis_taps(n_in, n_out), n_in), whole,
                               atol=1e-6)
    x = torch.randn(2, 3, n_in, 4, generator=torch.Generator().manual_seed(n_in))
    full = tresize.resize_bilinear_align_corners(x, (n_out, 4))
    scale = n_out // n_in
    for a in range(n_in):  # a window of rows [a − 1, b] for output rows [scale·a, scale·b)
        b = min(a + 3, n_in)
        lo, hi = max(a - 1, 0), min(b + 1, n_in)
        rows = tresize.resize_rows(x[:, :, lo:hi], lo, n_in, n_out, scale * a, scale * b)
        assert torch.equal(rows, full[:, :, scale * a:scale * b])
    with pytest.raises(ValueError, match="do not hold"):
        tresize.resize_rows(x[:, :, 1:], 1, n_in, n_out, 0, n_out)


def test_export_refuses_a_batch_that_does_not_divide(mg, tmp_path):
    state = tasm.add_uncertainty(tasm.build_trunk(ranks.UNET), ranks.UNET, device="cpu",
                                 generator=torch.Generator().manual_seed(0)).replace(lhat=1.0)
    with pytest.raises(ValueError, match="divide"):
        texport.export_serving_artifact(state, str(tmp_path / "a"), batch_size=3, height=32,
                                        width=32, n_devices=2)


def test_a_dp_artifact_refuses_to_serve_on_fewer_ranks(mg, tmp_path):
    with pytest.raises(ValueError, match="data-parallel over 2"):
        texport.load_serving_artifact(str(mg["tmp"] / "art2.pt2"), "cpu")
    assert texport.artifact_meta(str(mg["tmp"] / "art2.pt2"))["n_devices"] == 2
    with pytest.raises(SystemExit, match="data-parallel over 2 devices but this host runs 1"):
        tinfer.main(["--artifact", str(mg["tmp"] / "art2.pt2"), "--input",
                     str(mg["tmp"] / "serve.npy"), "--output", str(tmp_path), "--device", "cpu"])


def test_a_dp_artifact_binds_the_first_ranks_of_a_larger_group(monkeypatch):
    """In a group of 3 ranks an artifact for 2 binds ranks 0 and 1 (their
    own group) and leaves rank 2 idle; a group of 1 is refused."""
    groups = []
    monkeypatch.setattr(texport.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(texport.dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(texport.dist, "new_group", lambda ranks: groups.append(ranks) or "g01")
    cpu = torch.device("cpu")
    for rank, want in ((1, (tmesh.Mesh("g01", 2, 1, cpu), False)), (2, (None, True))):
        monkeypatch.setattr(texport.dist, "get_rank", lambda r=rank: r)
        assert texport._artifact_mesh(2, cpu) == want
    assert groups == [[0, 1], [0, 1]]
    monkeypatch.setattr(texport.dist, "get_world_size", lambda: 1)
    with pytest.raises(ValueError, match="data-parallel over 2 devices but this host runs 1"):
        texport._artifact_mesh(2, cpu)


def test_seeds_that_do_not_divide_over_the_ranks_are_refused():
    st = tasm.UQState(model=None, params=ranks.UNET)
    opt = lambda p: torch.optim.SGD(p, lr=0.1)  # noqa: E731
    states = multiseed.init_multiseed_states(st, [0, 1, 2], opt, torch.zeros(1))
    two = tmesh.Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="3 seeds must divide over the mesh's 2 ranks"):
        multiseed.shard_multiseed_state(states, two)
    step = multiseed.make_multiseed_train_step(st, opt, two)
    with pytest.raises(ValueError, match="another optimizer or sharded over another mesh"):
        step(states, None, None, None)


def test_height_sharding_refuses_narrow_images_and_train_mode():
    two = tmesh.Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="width of at least 16"):
        with spatial.height_sharded(two, 64, 8):
            pass
    with spatial.height_sharded(None, 64, 8) as sh:
        assert sh is None and spatial.active() is None
    st = tasm.add_uncertainty(tasm.build_trunk(ranks.UNET), ranks.UNET, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    st.model.train()
    with spatial.height_sharded(two, 40, 32), pytest.raises(ValueError, match="eval mode only"):
        st.model(torch.zeros(1, 1, 16, 32))
    assert spatial.active() is None
