"""Ranks of a data-parallel group on the CPU, for the port's parallel tests.

:func:`run_ranks` starts this file in ``n`` processes, ranks of one gloo
group on a free localhost port, each running one of the ``WORKERS`` below on
its shard and saving what it computed under the test's directory; it waits
at most ``timeout`` seconds and kills every child on a timeout or a failure,
so that a collective that never completes fails the test instead of hanging
it. The workers import only the port, as its entry points would.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

REPO = Path(__file__).resolve().parent.parent

LR = 1e-2  # SGD, as tests/test_parallel.py's mesh step
UNET = dict(
    model="UNet", uncertainty_type="quantiles", q_lo=0.05, q_hi=0.95, q_lo_weight=1.0,
    q_hi_weight=1.0, mse_weight=1.0, resize_backend="xla", lane_pack=False,
)
# train step cases: (config overrides, the model's dtype)
TRAIN_CASES = {
    "xla": ({}, torch.float32),
    "pallas": ({"conv_backend": "pallas"}, torch.float32),
    "pallas_fused": ({"conv_backend": "pallas_fused"}, torch.float32),
    "xla_bf16": ({"compute_dtype": "bfloat16"}, torch.float32),
    "pallas_fused_bf16": ({"conv_backend": "pallas_fused", "compute_dtype": "bfloat16"},
                          torch.float32),
    "xla_f64": ({}, torch.float64),
    "pallas_fused_f64": ({"conv_backend": "pallas_fused"}, torch.float64),
    "xla_f64_remat_conv": ({"remat": "conv"}, torch.float64),
    "pallas_fused_f64_remat_full": ({"conv_backend": "pallas_fused", "remat": "full"},
                                    torch.float64),
}
# elements kept of each tensor where a result leaves its process
SAMPLE = 4096
CALIB = dict(UNET, rcps_loss="fraction_missed", alpha=0.2, delta=0.2, num_lambdas=30,
             minimum_lambda=0.0, maximum_lambda=3.0, batch_size=4)


class TorchStandIn(nn.Module):
    """A head output (B, 3, C, H, W) that is an elementwise function of the
    input, bit for bit the JAX stand-in's of ``test_torch_port_router.py``;
    the parameter only places it."""

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return torch.stack([x - torch.sqrt(x.abs() + 0.05), x, x + torch.sqrt(x.abs() + 0.1)], 1)


def sample(tensors: dict) -> dict:
    """At most SAMPLE elements of each tensor, in f64, at positions drawn
    from a seeded generator (a stride could alias the 3x3 taps): what a
    full-width UNet's results keep when they are written to disk."""
    out = {}
    for k, t in tensors.items():
        flat = t.detach().double().flatten()
        if flat.numel() > SAMPLE:
            idx = torch.randperm(flat.numel(), generator=torch.Generator().manual_seed(0))
            flat = flat[idx[:SAMPLE].sort().values]
        out[k] = flat.clone()
    return out


def replicas_equal(tensors: dict, mesh) -> bool:
    """Whether every rank holds rank 0's tensors bit for bit."""
    same = True
    for t in tensors.values():
        t0 = t.detach().clone()
        mesh.broadcast_(t0)
        same &= bool(torch.equal(t0, t.detach()))
    return not mesh.agree(not same)


def train_step_once(weights: dict, cfg: dict, dtype: torch.dtype, batch: tuple, mesh) -> dict:
    """One SGD step of ``weights`` under ``cfg`` in ``dtype`` on this rank's
    slice of ``batch`` (all of it without a mesh) → the loss, and samples of
    the gradients and of the state dict after the step, in f64; over a mesh,
    whether the ranks hold the same gradients and state."""
    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
    from im2im_uq_tpu_torch.training import train as ttrain

    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    st.model.load_state_dict(weights)
    st.model.to(dtype)
    opt = torch.optim.SGD(st.model.parameters(), lr=LR)
    step = ttrain.make_train_step(st.model, head_loss_pe_fn(cfg["uncertainty_type"]), cfg, opt,
                                  mesh)
    tensors = ttrain.put_batch(*mesh_lib.put_batch(mesh, *batch), torch.device("cpu"))
    loss = step(*(t.to(dtype) for t in tensors))
    grads = {n: p.grad for n, p in st.model.named_parameters()}
    state = st.model.state_dict()
    out = {"loss": float(loss), "grads": sample(grads), "state": sample(state)}
    if mesh is not None:
        out["replicas_equal"] = replicas_equal({**grads, **state}, mesh)
    return out


def standin_state():
    from im2im_uq_tpu_torch.models import assembly as tasm

    return tasm.UQState(model=TorchStandIn(), params=CALIB)


def calibration_results(weights: dict, mesh) -> dict:
    """The loss tables, λ̂, risks, set metrics and served intervals of the
    stand-in and of the UNet of ``weights``, over ``mesh`` (or none)."""
    from im2im_uq_tpu_torch.calibration import metrics as tmetrics
    from im2im_uq_tpu_torch.calibration import rcps as trcps
    from im2im_uq_tpu_torch.data.synthetic import SyntheticDataset
    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.scripts import infer as tinfer

    out = {}
    grid = trcps.lambda_grid(CALIB)
    shifted = grid - (grid[1] - grid[0])
    ds = SyntheticDataset(num_examples=10, image_size=16, seed=41)
    st = standin_state()
    cal, table = trcps.calibrate_model(st, ds, CALIB, mesh=mesh)
    m = tmetrics.eval_set_metrics(st, ds, CALIB, mesh=mesh, lam=0.3,
                                  rng=np.random.RandomState(5))
    out["standin"] = {
        "lhat": cal.lhat, "calib_table": table,
        # a batch of 5 rounds up to 6 over two ranks
        "table_b5": trcps.compute_loss_table(st, ds, grid, batch_size=5, mesh=mesh),
        "risks": trcps.compute_risks_device(st, ds, shifted, batch_size=4, mesh=mesh),
        "metrics": m._asdict(),
        "risk_only": tmetrics.eval_risk_only(st.set_lhat(0.3), ds, CALIB, mesh=mesh),
    }
    unet = tasm.add_uncertainty(tasm.build_trunk(CALIB), CALIB, device="cpu")
    unet.model.load_state_dict(weights)
    cal, table = trcps.calibrate_model(unet, ds, CALIB, mesh=mesh)
    serve = np.stack([ds[i][0] for i in range(5)])
    out["unet"] = {
        "lhat": cal.lhat, "calib_table": table,
        "risks": trcps.compute_risks_device(unet, ds, shifted, batch_size=4, mesh=mesh),
        # 5 images at a batch of 3, rounded to 4 over two ranks: the last
        # batch padded, and nested_sets padding a batch of 1 to 2
        "served": tinfer.predict_intervals(cal, serve, batch_size=3, mesh=mesh),
        "sets_odd": [t.numpy() for t in cal.nested_sets(
            tasm.nchw_from_nhwc(serve[:3], "cpu"), mesh=mesh)],
    }
    return out


def train_net_results(weights: dict, tmp: Path, mesh, batch_size: int) -> dict:
    """Two epochs of ``train_net`` (Adam) from ``weights`` on 14 synthetic
    16x16 images with checkpoints and a metrics log under ``tmp`` → the log's
    records and a sample of the final state dict."""
    from im2im_uq_tpu_torch.data.synthetic import SyntheticDataset
    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.training import train as ttrain
    from im2im_uq_tpu_torch.utils.logging import MetricsLogger

    cfg = dict(UNET, dataset="synthetic", batch_size=batch_size, lr=1e-3,
               input_normalization="standard", output_normalization="min-max")
    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    st.model.load_state_dict(weights)
    train = SyntheticDataset(num_examples=14, image_size=16, seed=50)
    val = SyntheticDataset(num_examples=6, image_size=16, seed=51)
    logger = MetricsLogger(str(tmp / "log"), use_wandb=False)
    ttrain.train_net(st, train, val, mesh, epochs=2, batch_size=batch_size, lr=cfg["lr"],
                     checkpoint_dir=str(tmp / "ckpt"), validate_every=1, config=cfg,
                     logger=logger)
    logger.close()
    return {"state": sample(st.model.state_dict())}


def worker_all(mesh, tmp: Path) -> dict:
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    return {
        "train": {case: train_step_once(inp["weights"], dict(UNET, **extra), dtype,
                                        inp["batch"], mesh)
                  for case, (extra, dtype) in TRAIN_CASES.items()},
        "calibration": calibration_results(inp["weights"], mesh),
        # batch 7 runs as 8 over two ranks
        "train_net": train_net_results(inp["weights"], tmp / "train_net", mesh, 7),
    }


WORKERS = {"all": worker_all}


def run_ranks(worker: str, tmp: Path, n: int = 2, timeout: float = 120.0) -> list[dict]:
    """``WORKERS[worker]`` in ``n`` ranks of one gloo group → each rank's
    results, in rank order."""
    from im2im_uq_tpu_torch.parallel.distributed import free_port

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, worker, str(tmp)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(tmp / f"{worker}_rank{r}.pt", weights_only=False) for r in range(n)]


if __name__ == "__main__":
    torch.set_num_threads(1)
    from im2im_uq_tpu_torch.parallel import distributed
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib

    name, tmp = sys.argv[1], Path(sys.argv[2])
    distributed.init_distributed(device="cpu", timeout=datetime.timedelta(seconds=90))
    mesh = mesh_lib.data_parallel_mesh("cpu")
    torch.save(WORKERS[name](mesh, tmp), tmp / f"{name}_rank{mesh.rank}.pt")
