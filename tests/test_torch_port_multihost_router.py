"""The port's router over two ranks against its one-process run.

The router's ``main`` runs once in this process (one device) and once as two
ranks of one gloo group, started by ``parallel/distributed.spawn_per_device``
as a launcher would start them (at most 120 s; the ranks are killed on a
timeout). Both run the same synthetic grid point (16 images of 32x32, one
epoch at batch 4, L = 20) on the CPU, each into its own directories.

- The two-rank run writes the one-process run's artifacts, under the same
  names (those of the JAX router, ``test_torch_port_router.py``), with the
  same pickle keys, value types and shapes, and each once: the files that
  rank 0 alone writes are announced once in the ranks' output, and the
  metrics log holds the one-process run's records.
- Its results within a tolerance of the one-process run's. Training is the
  same program (the global batch's step, ``test_torch_port_parallel.py``),
  but Adam moves each parameter by about lr·sign(g) at its first steps, and
  a conv bias before a BatchNorm has an exact gradient of 0, so its
  rounding noise takes either sign in either run: those biases end up to
  2·lr·steps (4e-3) apart. Train-mode BatchNorm cancels them, but the
  eval-mode forward does not (the running mean took a tenth of the batch
  mean), so the calibrated model's interval edges move by about that much
  and pixels near an edge change sides. Bars, with what was measured: the
  data (inputs, ground truth) equal; λ̂ within one step of the λ grid
  (equal); the loss tables' mean absolute difference within 1e-2 (1.7e-3,
  up to 52 of a cell's 1024 pixels apart), the risk within 2e-2 (4.9e-3);
  the sampled sizes and the predictions within atol 5e-3 plus rtol 5e-2
  (1.7e-3 and 5e-4 at most).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import pytest
import yaml

from im2im_uq_tpu.utils.config import DEFAULTS

from im2im_uq_tpu_torch.calibration import rcps as trcps
from im2im_uq_tpu_torch.parallel import distributed as tdist
from im2im_uq_tpu_torch.scripts import router as trouter
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.full  # spawns interpreters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(
    DEFAULTS, dataset="synthetic", num_examples=16, image_size=32,
    data_split_percentages=[0.5, 0.25, 0.25, 0.0], model="UNet",
    uncertainty_type="quantiles", num_lambdas=20, epochs=1, batch_size=4, lr=1e-3,
    checkpoint_every=1, validate_every=1, num_validation_images=2,
    resize_backend="xla", lane_pack=False,
)
WRITTEN_ONCE = ["Checkpoint 1 saved!", "Calibrated checkpoint saved", "Loss table saved!",
                "Results saved to file"]


def _config(root, side: str) -> tuple[dict, str]:
    cfg = dict(CONFIG, output_dir=str(root / side / "out"),
               checkpoint_dir=str(root / side / "ckpt"))
    path = root / f"{side}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def _listing(cfg: dict) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), os.path.dirname(cfg["output_dir"]))
                  for key in ("output_dir", "checkpoint_dir")
                  for d, _, files in os.walk(cfg[key]) for f in files)


def _load(path: str):
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("routers")
    one, one_path = _config(root, "one")
    two, two_path = _config(root, "two")
    assert trouter.main(["--config", one_path, "--device", "cpu"]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("PYTHONPATH", REPO)
        log = root / "ranks.log"
        with open(log, "w") as fh:
            rc = tdist.spawn_per_device(
                ["-m", "im2im_uq_tpu_torch.scripts.router", "--config", two_path, "--device", "cpu"],
                2, timeout=120, stdout=fh)
    return {"one": one, "two": two, "rc": rc, "log": log.read_text()}


def test_two_ranks_write_the_one_process_artifacts_once(runs):
    assert runs["rc"] == 0, runs["log"][-4000:]
    one, two = runs["one"], runs["two"]
    assert [p.replace("one/", "", 1) for p in _listing(one)] == [
        p.replace("two/", "", 1) for p in _listing(two)]
    for name in (trouter.results_filename, trouter.loss_table_filename):
        assert os.path.basename(name(one)) == os.path.basename(name(two))
        assert os.path.exists(name(two))
    for line in WRITTEN_ONCE:
        assert runs["log"].count(line) == 1, line
    assert runs["log"].count("Computing the results from scratch!") == 2  # both ranks ran
    records = [json.loads(r) for r in
               open(os.path.join(two["output_dir"], "metrics.jsonl")).read().splitlines()]
    want = [json.loads(r) for r in
            open(os.path.join(one["output_dir"], "metrics.jsonl")).read().splitlines()]
    assert [sorted(r) for r in records] == [sorted(r) for r in want]


def test_two_ranks_results_have_the_one_process_schema(runs):
    got = _load(trouter.results_filename(runs["two"]))
    want = _load(trouter.results_filename(runs["one"]))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w) or (np.isscalar(g) and np.isscalar(w)), key
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, key
        if isinstance(w, list):
            assert [np.shape(a) for a in g] == [np.shape(a) for a in w], key
    tg, tw = (_load(trouter.loss_table_filename(runs[s])) for s in ("two", "one"))
    assert tg.shape == tw.shape == (8, 20) and tg.dtype == tw.dtype


def test_two_ranks_results_match_one_process(runs):
    got = _load(trouter.results_filename(runs["two"]))
    want = _load(trouter.results_filename(runs["one"]))
    for key in ("inputs", "gt"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    grid = trcps.lambda_grid(runs["one"])
    assert abs(got["lhat"] - want["lhat"]) <= (grid[1] - grid[0]) * (1 + 1e-9)
    tg, tw = (_load(trouter.loss_table_filename(runs[s])) for s in ("two", "one"))
    assert np.abs(tg - tw).mean() <= 1e-2
    assert abs(got["risk"] - want["risk"]) <= 2e-2
    for key in ("sizes", "predictions"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=5e-2,
                                   atol=5e-3, err_msg=key)
