"""Port parity: ``loader_procs`` and ``async_checkpoint`` in ``train_net``.

- ``loader_procs: N`` fetches the items in N spawned worker processes
  (``data/core.ProcessPoolFetcher``); its batches are the threaded
  loader's, bit for bit, and so is a ``train_net`` run on them. A stream
  dataset is refused with the JAX package's message.
- ``async_checkpoint: true`` writes each epoch's checkpoint on a background
  thread from a host copy taken at save time: the files hold the
  synchronous run's values bit for bit, a resume from them continues as
  from the synchronous ones, the readers wait for a pending write, and a
  failed write is raised at the next wait. ``checkpoint_backend`` changes
  no file name here: the JAX package writes msgpack for every value but
  "orbax" and refuses none, and the port writes ``.pt`` for each.
"""

from __future__ import annotations

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from im2im_uq_tpu.training import checkpoint as jckpt
from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.data.core import ProcessPoolFetcher, iterate_batches
from im2im_uq_tpu_torch.data.synthetic import SyntheticDataset
from im2im_uq_tpu_torch.models import assembly as tasm
from im2im_uq_tpu_torch.training import checkpoint as tckpt
from im2im_uq_tpu_torch.training import train as ttrain
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(DEFAULTS, model="UNet", uncertainty_type="quantiles", dataset="synthetic",
           batch_size=4, lr=1e-3, input_normalization="standard",
           output_normalization="min-max")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied when the test ends: one checkpoint of the
    full-width model with Adam's state takes about 207 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _ds(n: int = 4):
    return SyntheticDataset(num_examples=n, image_size=16, seed=60)


def _state(seed: int = 0):
    return tasm.add_uncertainty(tasm.build_trunk(CFG), CFG,
                                generator=torch.Generator().manual_seed(seed), device="cpu")


def _train(epochs: int, ckpt_dir=None, resume: bool = False, state=None, **config):
    state = state or _state()
    ttrain.train_net(state, _ds(), _ds(4), None, epochs=epochs, batch_size=4, lr=1e-3,
                     load_from_checkpoint=resume, checkpoint_dir=ckpt_dir, validate_every=2,
                     config=dict(CFG, **config))
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ loader_procs


def test_loader_procs_batches_are_the_threaded_loaders():
    ds = _ds(8)
    kw = dict(shuffle=True, pad_mode="wrap")
    want = list(iterate_batches(ds, 4, rng=np.random.RandomState(3), **kw))
    with ProcessPoolFetcher(ds, 2) as fetcher:
        got = list(iterate_batches(ds, 4, rng=np.random.RandomState(3), fetcher=fetcher, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_train_net_with_loader_procs_is_the_threaded_run():
    assert _equal(_train(2, loader_procs=2), _train(2))


class _Stream:
    def __iter__(self):
        return iter(_ds(4)[i] for i in range(4))


def test_loader_procs_refuses_a_stream_as_jax():
    with pytest.raises(ValueError, match="loader_procs requires a map-style dataset"):
        ttrain.train_net(_state(), _Stream(), _ds(4), None, epochs=1, batch_size=4, lr=1e-3,
                         config=dict(CFG, loader_procs=2))


# -------------------------------------------------------- async_checkpoint


def _payloads(ckpt_dir, epochs: int) -> list[dict]:
    return [torch.load(tckpt.checkpoint_path(str(ckpt_dir), e, CFG), weights_only=True)
            for e in range(1, epochs + 1)]


def _same_payload(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_payload(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_payload(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)  # λ̂ NaN for none


def test_async_checkpoints_equal_the_synchronous_ones_and_resume_alike(tmp_path):
    sync_final = _train(1, tmp_path / "sync")
    async_final = _train(1, tmp_path / "async", async_checkpoint=True)
    assert _equal(async_final, sync_final)
    assert _same_payload(*(_payloads(tmp_path / side, 1)[0] for side in ("async", "sync")))
    # resume both at epoch 1 and train a second epoch
    resumed = [_train(2, tmp_path / side, resume=True, state=_state(9), async_checkpoint=True)
               for side in ("sync", "async")]
    assert _equal(*resumed)
    assert _same_payload(*(_payloads(tmp_path / side, 2)[1] for side in ("sync", "async")))


def test_readers_wait_for_a_pending_save(tmp_path, monkeypatch):
    write = tckpt._write
    started = threading.Event()

    def slow_write(payload, path):
        started.set()
        time.sleep(0.5)
        write(payload, path)

    monkeypatch.setattr(tckpt, "_write", slow_write)
    state = _state()
    opt = torch.optim.Adam(state.model.parameters())
    path = tckpt.checkpoint_path(str(tmp_path), 1, CFG)
    tckpt.save_checkpoint(path, state.model, opt, 0.5, 1, async_save=True)
    assert started.wait(5.0)
    assert tckpt.find_resume_checkpoint(str(tmp_path), 1, CFG) == (path, 1)
    assert tckpt.restore_checkpoint(path, _state(1).model, opt) == (0.5, 1)


def test_a_failed_background_write_is_raised_at_the_next_wait(tmp_path):
    (tmp_path / "file").write_text("")
    state = _state()
    opt = torch.optim.Adam(state.model.parameters())
    bad = str(tmp_path / "file" / "CP_epoch1.pt")  # its directory is a file
    tckpt.save_checkpoint(bad, state.model, opt, None, 1, async_save=True)
    with pytest.raises(OSError):
        tckpt.wait_for_async_saves()
    tckpt.wait_for_async_saves()  # raised once, then cleared


@pytest.mark.parametrize("backend", ["flax", "orbax", "anything"])
def test_every_checkpoint_backend_writes_the_same_pt(tmp_path, backend):
    cfg = dict(CFG, checkpoint_backend=backend)
    # the JAX package takes every value, msgpack for all but orbax
    suffix = ".orbax" if backend == "orbax" else ".msgpack"
    assert jckpt.checkpoint_path("d", 1, cfg).endswith(suffix)
    assert tckpt.checkpoint_path("d", 1, cfg) == tckpt.checkpoint_path("d", 1, CFG)
    # train_net reads the config as given (an epoch over 4 images, no checkpoint kept)
    _train(1, None, checkpoint_backend=backend, async_checkpoint=True)
    state = _state()
    path = tckpt.checkpoint_path(str(tmp_path), 1, cfg)
    tckpt.save_checkpoint(path, state.model, torch.optim.Adam(state.model.parameters()), None, 1,
                          async_save=True)
    assert tckpt.find_resume_checkpoint(str(tmp_path), 1, cfg) == (path, 1)
