"""Port parity: ``input_pipeline: grain`` without grain, and its mid-epoch checkpoints.

- The order: ``data/grain_pipeline.grain_order`` (numpy) against grain's
  own C++ ``index_shuffle`` module, position for position, for n from 1 to
  5000 (1, powers of two and 2^k ± 1, and others) and several seeds; the
  shuffle's seed against the one grain's ``MapDataset.seed(s).shuffle()``
  derives.
- The iterator: the port's ``CheckpointableBatchIterator`` /
  ``grain_batches`` / ``make_grain_dataset`` against the JAX package's, which
  run grain, on the same dataset: shuffled or not, shards, padding (zeros,
  wrap, none), several epochs, and ``set_state`` resume. Bit for bit.
- ``train_net`` under grain: the port against the JAX package on the same
  weights (a UNet at 16², 8 examples, batch 4, 2 epochs), each epoch's
  ``train_loss`` within rtol 2e-2 (``test_torch_port_train.py``'s bar for
  f32 steps after Adam updates); the port's batches take grain's C++ order,
  injected. And the port stopped by SIGTERM mid-epoch and resumed equals
  its uninterrupted run bit for bit: weights, BatchNorm statistics, Adam's
  state and both epochs' losses.
"""

from __future__ import annotations

import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("grain")

import grain.python as grain  # noqa: E402
from grain._src.python.experimental.index_shuffle.python import (  # noqa: E402
    index_shuffle_module,
)

from im2im_uq_tpu.data import grain_pipeline as jgrain  # noqa: E402
from im2im_uq_tpu.data.synthetic import SyntheticDataset as JSynthetic  # noqa: E402
from im2im_uq_tpu.models import assembly as jasm  # noqa: E402
from im2im_uq_tpu.training import train as jtrain  # noqa: E402
from im2im_uq_tpu.utils.config import DEFAULTS  # noqa: E402

from im2im_uq_tpu_torch.data import grain_pipeline as tgrain  # noqa: E402
from im2im_uq_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from im2im_uq_tpu_torch.interop.from_jax import load_jax_variables  # noqa: E402
from im2im_uq_tpu_torch.models import assembly as tasm  # noqa: E402
from im2im_uq_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from im2im_uq_tpu_torch.training import train as ttrain  # noqa: E402
from _torch_port_ranks import one_intra_op_thread  # noqa: E402,F401  (autouse)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied when the test ends: one checkpoint of the
    full-width model with Adam's state takes about 207 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cpp_order(n: int, seed: int) -> np.ndarray:
    """Grain's C++ index_shuffle, position by position."""
    return np.array([index_shuffle_module.index_shuffle(i, max_index=n - 1, seed=seed, rounds=4)
                     for i in range(n)])


# ------------------------------------------------------------------ order

ORDER_CASES = [
    [1, 2, 3, 4, 5],
    [7, 8, 9, 15, 16, 17, 31, 32, 33],
    [63, 64, 65, 127, 128, 129],
    [255, 256, 257, 511, 512, 513],
    [1023, 1024, 1025, 2047, 2048, 2049],
    [4095, 4096, 4097, 5000],
    [10, 100, 777, 1500, 3333],
]


@pytest.mark.parametrize("sizes", ORDER_CASES)
def test_grain_order_is_grain_cpp_index_shuffle(sizes):
    r = np.random.RandomState(sum(sizes))
    for n in sizes:
        for seed in (0, 7, 422405834, int(r.randint(0, 2**32, dtype=np.uint64))):
            np.testing.assert_array_equal(tgrain.grain_order(n, seed), _cpp_order(n, seed),
                                          err_msg=f"n={n} seed={seed}")


@pytest.mark.parametrize("seed", [0, 1, 1001, 2**31 + 5])
def test_shuffle_seed_is_grains_derived_seed(seed):
    ds = grain.MapDataset.source(list(range(10))).seed(seed).shuffle()
    assert tgrain.shuffle_seed(seed) == ds._seed
    assert [ds[i] for i in range(10)] == tgrain.grain_order(10, ds._seed).tolist()


# --------------------------------------------------------------- iterator


class _Indexed:
    """(x, y) pairs whose pixels carry the example's index."""

    def __init__(self, n, size=4):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full((self.size, self.size, 1), float(i), np.float32)
        return x, -x


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


ITER_CASES = [
    dict(shuffle=False),
    dict(shuffle=True, seed=5),
    dict(shuffle=True, seed=1001, pad_mode="wrap"),
    dict(shuffle=True, seed=3, shard_index=1, shard_count=3),
    dict(shuffle=False, shard_index=0, shard_count=2, pad_final=False),
    dict(shuffle=True, seed=9, num_epochs=3, pad_mode="wrap"),
]


@pytest.mark.parametrize("kw", ITER_CASES)
def test_iterator_matches_jax(kw):
    ds = _Indexed(11)
    _same(tgrain.CheckpointableBatchIterator(ds, 4, **kw),
          jgrain.CheckpointableBatchIterator(ds, 4, **kw))


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=2), dict(shard_index=1, shard_count=2)])
def test_grain_batches_and_dataset_view_match_jax(kw):
    ds = _Indexed(13)
    _same(tgrain.grain_batches(ds, 4, pad_mode="wrap", **kw),
          jgrain.grain_batches(ds, 4, pad_mode="wrap", **kw))
    view, want = tgrain.make_grain_dataset(ds, 4, **kw), jgrain.make_grain_dataset(ds, 4, **kw)
    assert len(view) == len(want)
    _same((view[i] for i in range(len(view))), (want[i] for i in range(len(want))))


def test_injected_order_is_the_one_read():
    ds = _Indexed(10)
    got = tgrain.CheckpointableBatchIterator(ds, 5, shuffle=True, seed=4, order=_cpp_order)
    _same(got, jgrain.CheckpointableBatchIterator(ds, 5, shuffle=True, seed=4))
    with pytest.raises(ValueError, match="not a permutation"):
        next(tgrain.CheckpointableBatchIterator(ds, 5, shuffle=True,
                                                order=lambda n, s: np.zeros(n, int)))


@pytest.mark.parametrize("taken", [0, 1, 2, 3])
def test_set_state_resumes_as_jax(taken):
    ds = _Indexed(12)
    kw = dict(shuffle=True, seed=7, pad_mode="wrap")
    mine, theirs = tgrain.CheckpointableBatchIterator(ds, 5, **kw), \
        jgrain.CheckpointableBatchIterator(ds, 5, **kw)
    for _ in range(taken):
        next(mine), next(theirs)
    state = mine.get_state()
    assert state == theirs.get_state() == {"next_index": taken}
    fresh_mine = tgrain.CheckpointableBatchIterator(ds, 5, **kw)
    fresh_theirs = jgrain.CheckpointableBatchIterator(ds, 5, **kw)
    fresh_mine.set_state(json.loads(json.dumps(state)))
    fresh_theirs.set_state(state)
    if taken == 3:  # the epoch's three batches are taken
        assert list(fresh_mine) == [] == list(fresh_theirs)
    else:
        _same(fresh_mine, fresh_theirs)


def test_set_state_out_of_range_raises():
    it = tgrain.CheckpointableBatchIterator(_Indexed(8), 4)
    it.set_state({"next_index": 2})
    assert list(it) == []
    for bad in (-1, 3):
        with pytest.raises(IndexError, match="out of"):
            it.set_state({"next_index": bad})


# -------------------------------------------------------------- train_net

CFG = dict(DEFAULTS, model="UNet", uncertainty_type="quantiles", resize_backend="xla",
           lane_pack=False, dataset="synthetic", batch_size=4, lr=1e-3,
           input_pipeline="grain", precompile_calibration=False)


class _Records:
    def __init__(self):
        self.rows = []

    def log(self, metrics):
        self.rows.append(dict(metrics))

    def losses(self):
        return [r["train_loss"] for r in self.rows if "train_loss" in r]


def test_train_net_matches_jax(monkeypatch):
    monkeypatch.setattr(tgrain, "grain_order", _cpp_order)
    jstate = jasm.add_uncertainty(jasm.build_trunk(CFG), CFG, rng=jax.random.key(0),
                                  example_input=jnp.zeros((1, 16, 16, 1)))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jstate.variables)))
    jlog, tlog = _Records(), _Records()
    jtrain.train_net(jstate, JSynthetic(num_examples=8, image_size=16, seed=3),
                     JSynthetic(num_examples=4, image_size=16, seed=4), None, epochs=2,
                     batch_size=4, lr=1e-3, validate_every=10, config=CFG, logger=jlog)
    tstate = tasm.add_uncertainty(tasm.build_trunk(CFG), CFG, device="cpu")
    load_jax_variables(tstate.model, variables, "UNet", "quantiles")
    ttrain.train_net(tstate, SyntheticDataset(num_examples=8, image_size=16, seed=3),
                     SyntheticDataset(num_examples=4, image_size=16, seed=4), None, epochs=2,
                     batch_size=4, lr=1e-3, validate_every=10, config=CFG, logger=tlog)
    assert len(tlog.losses()) == len(jlog.losses()) == 2
    np.testing.assert_allclose(tlog.losses(), jlog.losses(), rtol=2e-2)


SMALL = dict(CFG, resize_backend="auto")


class _Signaling:
    """Sends SIGTERM to this process when one example is read."""

    def __init__(self, dataset, index):
        self.dataset, self.index, self.sent = dataset, index, False

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        if i == self.index and not self.sent:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return self.dataset[i]


def _run(ckpt_dir, data, **kw):
    state = tasm.add_uncertainty(tasm.build_trunk(SMALL), SMALL,
                                 generator=torch.Generator().manual_seed(kw.pop("seed", 0)),
                                 device="cpu")
    log = _Records()
    out = ttrain.train_net(state, data, SyntheticDataset(num_examples=2, image_size=16, seed=2),
                           None, epochs=2, batch_size=2, lr=1e-3, checkpoint_dir=ckpt_dir,
                           checkpoint_every=2, validate_every=10, logger=log,
                           config=dict(SMALL, graceful_shutdown=True, checkpoint_every_steps=3),
                           **kw)
    return out, log


def _everything(state, ckpt_dir):
    """Weights and BatchNorm statistics from the model, Adam's state from
    the epoch-2 checkpoint."""
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    return sd, torch.load(tckpt.checkpoint_path(ckpt_dir, 2, SMALL),
                          weights_only=True)["optimizer"]["state"]


def test_sigterm_mid_epoch_then_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    ds = SyntheticDataset(num_examples=10, image_size=16, seed=1)  # 5 steps an epoch
    full_dir, d = str(tmp_path / "full"), str(tmp_path / "stopped")
    full, full_log = _run(full_dir, ds)
    # the first example of step 5 of epoch 0 (epoch seed 0 + 1000·0 + 1)
    index = int(tgrain.make_grain_dataset(ds, 2, shuffle=True, seed=1).indices(4)[0])
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(ttrain.PreemptionInterrupt) as exc:
        _run(d, _Signaling(ds, index))
    assert signal.getsignal(signal.SIGTERM) == before
    mp = tckpt.midepoch_checkpoint_path(d, SMALL)
    assert exc.value.checkpoint_path == mp and os.path.exists(mp)
    payload = torch.load(mp, weights_only=True)
    assert json.loads(payload["data_state"]) == {"next_index": 5}
    assert json.loads(payload["progress"])["steps"] == 5 and payload["epoch"] == 0
    capsys.readouterr()
    resumed, resumed_log = _run(d, ds, load_from_checkpoint=True, seed=9)
    assert "Resumed mid-epoch" in capsys.readouterr().out
    assert not os.path.exists(mp)  # the epoch completed
    assert resumed_log.losses() == full_log.losses() and len(full_log.losses()) == 2
    (want_sd, want_adam), (got_sd, got_adam) = _everything(full, full_dir), _everything(resumed, d)
    assert want_sd.keys() == got_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert want_adam.keys() == got_adam.keys()
    for i in want_adam:
        for name, v in want_adam[i].items():
            assert torch.equal(got_adam[i][name], v), (i, name)


def test_midepoch_checkpoint_round_trip_and_epoch_window(tmp_path):
    state = tasm.add_uncertainty(tasm.build_trunk(SMALL), SMALL,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(state.model.parameters(), lr=1e-3)
    step = ttrain.make_train_step(state.model, lambda o, y, h: (o[:, 1] - y).abs().mean((1, 2, 3)),
                                  SMALL, opt)
    step(torch.rand(2, 1, 16, 16), torch.rand(2, 1, 16, 16), torch.ones(2))
    path = tckpt.midepoch_checkpoint_path(str(tmp_path), SMALL)
    assert os.path.basename(path) == f"CP_midepoch_{tckpt.checkpoint_key(SMALL)}.pt"
    tckpt.save_midepoch_checkpoint(path, state.model, opt, 0.5, 3, {"next_index": 4},
                                   {"sum_loss": 1.25, "num_examples": 8, "steps": 4})
    other = tasm.add_uncertainty(tasm.build_trunk(SMALL), SMALL,
                                 generator=torch.Generator().manual_seed(1), device="cpu")
    other_opt = torch.optim.Adam(other.model.parameters(), lr=1e-3)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    assert tckpt.restore_midepoch_checkpoint(path, other.model, other_opt, (4, 9)) is None
    assert all(torch.equal(v, before[k]) for k, v in other.model.state_dict().items())
    got = tckpt.restore_midepoch_checkpoint(path, other.model, other_opt, (0, 9))
    assert got == (0.5, 3, {"next_index": 4}, {"sum_loss": 1.25, "num_examples": 8, "steps": 4})
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    a, b = opt.state_dict()["state"], other_opt.state_dict()["state"]
    assert all(torch.equal(a[i][n], b[i][n]) for i in a for n in a[i])
