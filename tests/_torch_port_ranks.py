"""Ranks of a data-parallel group on the CPU, for the port's parallel tests.

:func:`run_ranks` starts this file in ``n`` processes, ranks of one gloo
group on a free localhost port, each running one of the ``WORKERS`` below on
its shard and saving what it computed under the test's directory; it waits
at most ``timeout`` seconds and kills every child on a timeout or a failure,
so that a collective that never completes fails the test instead of hanging
it (:func:`start_ranks` and :func:`wait_ranks` let the test process work
while they run). The workers import only the port, as its entry points
would.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
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
# the FastMRI hook's case: an f64 step on raw masked k-space (B, 24, 20, 2),
# reconstructed to 16x16 and normalised inside the step by the dataset's
# device_preprocess; each rank transforms its own slice
KSPACE_CASE = "xla_f64_kspace"
KSPACE_CROP = (16, 16)
KSPACE_NORM = {"input_mean": 0.1, "input_std": 0.9}
# elements kept of each tensor where a result leaves its process
SAMPLE = 4096
CALIB = dict(UNET, rcps_loss="fraction_missed", alpha=0.2, delta=0.2, num_lambdas=30,
             minimum_lambda=0.0, maximum_lambda=3.0, batch_size=4)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for a test module, as the ranks use; a port test
    module imports this fixture to apply it. The suite's xdist workers share
    the cores, and torch's thread pool in each of them oversubscribes them
    many times over (a grain test took 34x its single-process time so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TorchStandIn(nn.Module):
    """A head output (B, 3, C, H, W) that is an elementwise function of the
    input, bit for bit the JAX stand-in's of ``test_torch_port_router.py``;
    the parameter only places it."""

    def __init__(self):
        super().__init__()
        self.anchor = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return torch.stack([x - torch.sqrt(x.abs() + 0.05), x, x + torch.sqrt(x.abs() + 0.1)], 1)


_SAMPLED: dict = {}


def _sampled_positions(n: int) -> torch.Tensor:
    """SAMPLE sorted positions of n drawn from a generator seeded 0, made
    once per n (a full permutation of a 2.4M-element weight takes 30 ms)."""
    if n not in _SAMPLED:
        idx = torch.randperm(n, generator=torch.Generator().manual_seed(0))
        _SAMPLED[n] = idx[:SAMPLE].sort().values
    return _SAMPLED[n]


def sample(tensors: dict) -> dict:
    """At most SAMPLE elements of each tensor, in f64, at positions drawn
    from a seeded generator (a stride could alias the 3x3 taps): what a
    full-width UNet's results keep when they are written to disk."""
    out = {}
    for k, t in tensors.items():
        flat = t.detach().double().flatten()
        if flat.numel() > SAMPLE:
            flat = flat[_sampled_positions(flat.numel())]
        out[k] = flat.clone()
    return out


def replicas_equal(tensors: dict, mesh) -> bool:
    """Whether every rank holds rank 0's tensors bit for bit: each dtype's
    tensors flattened into one, broadcast from rank 0 and compared."""
    by_dtype: dict = {}
    for t in tensors.values():
        by_dtype.setdefault(t.dtype, []).append(t.detach().flatten())
    same = True
    for flat in (torch.cat(ts) for ts in by_dtype.values()):
        t0 = flat.clone()
        mesh.broadcast_(t0)
        same &= bool(torch.equal(t0, flat))
    return not mesh.agree(not same)


def kspace_preprocess():
    """The FastMRI dataset's on-device transform for KSPACE_CASE."""
    from types import SimpleNamespace

    from im2im_uq_tpu_torch.data.fastmri import FastMRIDataset

    like = SimpleNamespace(normalize_input="standard", norm_params=KSPACE_NORM)
    return FastMRIDataset.device_preprocess(like, KSPACE_CROP)


def train_step_once(weights: dict, cfg: dict, dtype: torch.dtype, batch: tuple, mesh,
                    preprocess=None) -> dict:
    """One SGD step of ``weights`` under ``cfg`` in ``dtype`` on this rank's
    slice of ``batch`` (all of it without a mesh) → the loss, and samples of
    the gradients and of the state dict after the step, in f64; over a mesh,
    whether the ranks hold the same gradients and state. ``preprocess``: the
    batch's input is raw, and the step's hook makes the model's input."""
    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
    from im2im_uq_tpu_torch.training import train as ttrain

    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    st.model.load_state_dict(weights)
    st.model.to(dtype)
    opt = torch.optim.SGD(st.model.parameters(), lr=LR)
    step = ttrain.make_train_step(st.model, head_loss_pe_fn(cfg["uncertainty_type"]), cfg, opt,
                                  mesh, preprocess=preprocess)
    tensors = ttrain.put_batch(*mesh_lib.put_batch(mesh, *batch), torch.device("cpu"),
                               raw_input=preprocess is not None)
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
        "train": {**{case: train_step_once(inp["weights"], dict(UNET, **extra), dtype,
                                           inp["batch"], mesh)
                     for case, (extra, dtype) in TRAIN_CASES.items()},
                  KSPACE_CASE: train_step_once(inp["weights"], UNET, torch.float64,
                                               inp["kspace_batch"], mesh, kspace_preprocess())},
        "calibration": calibration_results(inp["weights"], mesh),
        # batch 7 runs as 8 over two ranks
        "train_net": train_net_results(inp["weights"], tmp / "train_net", mesh, 7),
    }


# --------------------------------------------------- the multi-GPU API left

# the height-sharded cases: (image height, width, config overrides); the
# inputs carry the case's name
SPATIAL_CASES = {
    **{f"{h}x{w}_{b}": (h, w, {"conv_backend": b})
       for h, w in ((80, 48), (40, 32)) for b in ("xla", "pallas", "pallas_fused")},
    "80x48_pallas_fused_resize_pallas": (80, 48, {"conv_backend": "pallas_fused",
                                                  "resize_backend": "pallas"}),
    "40x32_wnet": (40, 32, {"model": "WNet"}),
    # rank 1's share is 8 rows: empty at the deepest level
    "24x16_xla": (24, 16, {"conv_backend": "xla"}),
}
SPATIAL_LAM = 1.25
SEEDS = (0, 1, 2, 3)
MULTISEED_LR = 1e-3


def spatial_state(name: str, weights: dict, device="cpu"):
    """The case's model with its weights (UNet or WNet) and λ̂ unset."""
    from im2im_uq_tpu_torch.models import assembly as tasm

    cfg = dict(UNET, **SPATIAL_CASES[name][2])
    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device=device)
    st.model.load_state_dict(weights[cfg.get("model", "UNet")])
    return st


def upnoskip_sharded(mesh, x: torch.Tensor) -> np.ndarray:
    """``UpNoSkip`` by 3 (torch's init from seed 5) on the rows of NCHW
    ``x`` split over ``mesh``, gathered; its whole-height output without a
    mesh of several ranks."""
    from im2im_uq_tpu_torch.models.unet import UpNoSkip
    from im2im_uq_tpu_torch.parallel import spatial

    torch.manual_seed(5)
    block = UpNoSkip(16, 8, scale_factor=3).eval()
    with torch.no_grad(), spatial.height_sharded(mesh, *x.shape[2:]) as sh:
        out = block(x) if sh is None else sh.gather(block(sh.take(x)), 2)
    return out.numpy()


def multiseed_run(cfg: dict, batches: list, mesh, weights: Optional[list] = None) -> dict:
    """init_multiseed_states of SEEDS (their weights replaced by
    ``weights[s]`` where given), sharded over ``mesh``, then one multi-seed
    Adam step per batch → this rank's seeds, the losses of each step, a
    sample of each local replica's state dict, and the collectives issued
    during the steps."""
    import torch.distributed as dist

    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.training import multiseed
    from im2im_uq_tpu_torch.training import train as ttrain

    st = tasm.UQState(model=None, params=cfg)
    opt = lambda p: torch.optim.Adam(p, lr=MULTISEED_LR)  # noqa: E731
    states = multiseed.init_multiseed_states(st, SEEDS, opt, torch.zeros((1, 1, 16, 16)))
    if weights is not None:
        for m, w in zip(states.models, weights):
            m.load_state_dict(w)
    states = multiseed.shard_multiseed_state(states, mesh)
    step = multiseed.make_multiseed_train_step(st, opt, mesh)
    calls = []
    names = ("all_reduce", "broadcast", "all_gather", "batch_isend_irecv", "send", "recv")
    saved = {n: getattr(dist, n) for n in names}
    for n in names:
        setattr(dist, n, lambda *a, _n=n, **k: calls.append(_n) or saved[_n](*a, **k))
    try:
        losses = [step(states, *ttrain.put_batch(*b, torch.device("cpu")))[1].tolist()
                  for b in batches]
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    return {"seeds": states.local_seeds, "losses": losses, "collectives": calls,
            "states": [sample(m.state_dict()) for m in states.models], "handle": states}


def worker_multigpu(mesh, tmp: Path) -> dict:
    """The artifact, height-sharded and multi-seed calls over ``mesh``; over
    a mesh of one rank (the worker ``multigpu_one``, which serves the
    one-process artifact) the same calls are the one-process path, the
    reference, computed under the ranks' thread settings (the CPU convs'
    algorithm, and so their bits, follows the threads a process starts
    with)."""
    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
    from im2im_uq_tpu_torch.parallel import spatial
    from im2im_uq_tpu_torch.scripts import export_serving as texport
    from im2im_uq_tpu_torch.scripts import infer as tinfer
    from im2im_uq_tpu_torch.training import multiseed

    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    multi = mesh_lib.spans(mesh)
    tag = "" if multi else "_one"
    art_path = str(tmp / ("art2.pt2" if multi else "art1.pt2"))
    art = texport.load_serving_artifact(art_path, "cpu")
    out = {"artifact": {
        "served": tinfer.predict_intervals(art, inp["serve"], art.batch_size),
        "ranks": (art.mesh.size, art.mesh.rank) if multi else (1, 0),
        "cli_rc": tinfer.main(["--artifact", art_path, "--input", str(tmp / "serve.npy"),
                               "--output", str(tmp / f"served{tag}"), "--device", "cpu"]),
    }}
    out["spatial"] = {}
    for name in SPATIAL_CASES:
        st = spatial_state(name, inp["weights"])
        x = torch.from_numpy(inp["spatial_x"][name])
        out["spatial"][name] = [t.numpy() for t in
                                spatial.spatial_nested_sets(st, mesh, lam=SPATIAL_LAM)(x)]
    out["upnoskip"] = upnoskip_sharded(mesh, torch.from_numpy(inp["upnoskip_x"]))
    cfg = dict(UNET, lr=MULTISEED_LR)
    run = multiseed_run(cfg, inp["batches"], mesh)
    states = run.pop("handle")
    template = tasm.UQState(model=None, params=cfg)
    x = torch.from_numpy(inp["serve"][:1].transpose(0, 3, 1, 2).copy())
    run["replicas"] = [sample(multiseed.replica_state(template, states, s).model.state_dict())
                       for s in range(len(SEEDS))]
    run["replica3_sets"] = [t.numpy() for t in
                            multiseed.replica_state(template, states, 3).nested_sets(x, lam=1.0)]
    out["multiseed"] = run
    if multi:
        jax_run = multiseed_run(cfg, inp["batches"], mesh, inp["jax_seed_weights"])
        jax_run.pop("handle")
        out["multiseed_jax_init"] = jax_run
        mesh.barrier()
    return out


# ------------------------------------------ make_train_multistep over a mesh

# the multistep cases: (config overrides, the model's dtype, the optimizer),
# K steps each; Adam's rate is tests/test_torch_port_multistep.py's
MULTISTEP_K = 3
MULTISTEP_CASES = {
    "xla_f64_sgd": ({}, torch.float64, "sgd"),
    "pallas_fused_f64_sgd": ({"conv_backend": "pallas_fused"}, torch.float64, "sgd"),
    "xla_f32_adam": ({}, torch.float32, "adam"),
}
MULTISTEP_LR = {"sgd": LR, "adam": 1e-3}
# how long the multistep ranks may take, in seconds
MULTISTEP_TIMEOUT = 120.0


def multistep_run(weights: dict, case: str, batch: tuple, mesh,
                  sequential: bool = False) -> tuple[torch.Tensor, dict]:
    """MULTISTEP_K steps of ``case`` from ``weights`` on this rank's slice of
    ``batch`` (all of it without a mesh): one ``make_train_multistep`` call,
    or (``sequential``) as many calls of ``make_train_step`` → the last
    loss, and every tensor of the model's state dict and of the optimizer's
    state after them."""
    from im2im_uq_tpu_torch.models import assembly as tasm
    from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
    from im2im_uq_tpu_torch.training import train as ttrain

    extra, dtype, opt_name = MULTISTEP_CASES[case]
    cfg = dict(UNET, **extra)
    st = tasm.add_uncertainty(tasm.build_trunk(cfg), cfg, device="cpu")
    st.model.load_state_dict(weights)
    st.model.to(dtype)
    make_opt = torch.optim.SGD if opt_name == "sgd" else torch.optim.Adam
    opt = make_opt(st.model.parameters(), lr=MULTISTEP_LR[opt_name])
    loss_pe = head_loss_pe_fn(cfg["uncertainty_type"])
    tensors = [t.to(dtype) for t in ttrain.put_batch(*mesh_lib.put_batch(mesh, *batch),
                                                     torch.device("cpu"))]
    if sequential:
        step = ttrain.make_train_step(st.model, loss_pe, cfg, opt, mesh)
        for _ in range(MULTISTEP_K):
            loss = step(*tensors)
    else:
        loss = ttrain.make_train_multistep(st.model, loss_pe, cfg, opt, MULTISTEP_K, mesh)(*tensors)
    state = {k: v.clone() for k, v in st.model.state_dict().items()}
    for i, s in opt.state_dict()["state"].items():
        state.update({f"opt.{i}.{n}": v.clone() for n, v in s.items()})
    return loss, state


def worker_multistep(mesh, tmp: Path) -> dict:
    """Each MULTISTEP_CASES case over ``mesh``: whether the multistep is the
    sequential steps bit for bit, whether the ranks hold the same bits, the
    loss and a sample of the state; and the message of the refusal of a
    mesh of CUDA ranks under this gloo group (no card needed: it is
    refused before any tensor moves)."""
    from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
    from im2im_uq_tpu_torch.training import train as ttrain

    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {}
    for case in MULTISTEP_CASES:
        loss, state = multistep_run(inp["weights"], case, inp["batch"], mesh)
        seq_loss, seq_state = multistep_run(inp["weights"], case, inp["batch"], mesh,
                                            sequential=True)
        out[case] = {
            "loss": float(loss), "loss_dtype": str(loss.dtype),
            "equal_to_sequential": (torch.equal(loss, seq_loss.float())
                                    and state.keys() == seq_state.keys()
                                    and all(torch.equal(v, seq_state[k])
                                            for k, v in state.items())),
            "replicas_equal": replicas_equal({"loss": loss, **state}, mesh),
            "state": sample(state),
        }
    cuda_ranks = mesh_lib.Mesh(mesh.group, mesh.size, mesh.rank, torch.device("cuda"))
    model = TorchStandIn()
    try:
        ttrain.make_train_multistep(model, head_loss_pe_fn("quantiles"), UNET,
                                    torch.optim.SGD(model.parameters(), lr=LR), MULTISTEP_K,
                                    cuda_ranks)
        out["gloo_on_cuda"] = None
    except ValueError as exc:
        out["gloo_on_cuda"] = str(exc)
    return out


WORKERS = {"all": worker_all, "multigpu": worker_multigpu, "multigpu_one": worker_multigpu,
           "multistep": worker_multistep}


def start_ranks(worker: str, tmp: Path, n: int = 2) -> list:
    """``WORKERS[worker]`` started in ``n`` ranks of one gloo group; wait
    for them with :func:`wait_ranks`."""
    from im2im_uq_tpu_torch.parallel.distributed import free_port

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, __file__, worker, str(tmp)],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def wait_ranks(procs: list, worker: str, tmp: Path, timeout: float = 120.0) -> list[dict]:
    """The ranks of :func:`start_ranks` waited for at most ``timeout``
    seconds (all killed on a timeout) → each rank's results, in rank
    order."""
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
    return [torch.load(tmp / f"{worker}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run_ranks(worker: str, tmp: Path, n: int = 2, timeout: float = 120.0) -> list[dict]:
    """``WORKERS[worker]`` in ``n`` ranks of one gloo group → each rank's
    results, in rank order."""
    return wait_ranks(start_ranks(worker, tmp, n), worker, tmp, timeout)


if __name__ == "__main__":
    torch.set_num_threads(1)
    from im2im_uq_tpu_torch.parallel import distributed
    from im2im_uq_tpu_torch.parallel import mesh as mesh_lib

    name, tmp = sys.argv[1], Path(sys.argv[2])
    distributed.init_distributed(device="cpu", timeout=datetime.timedelta(seconds=90))
    mesh = mesh_lib.data_parallel_mesh("cpu")
    result = WORKERS[name](mesh, tmp)
    # the monotonic clock is the machine's, so the test reads the rank's
    # wall time against the moment it started the ranks
    result["finished_at"] = time.monotonic()
    torch.save(result, tmp / f"{name}_rank{mesh.rank}.pt")
