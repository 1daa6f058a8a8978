"""Experiment router: config → train → calibrate → evaluate → artifacts.

Counterpart of ``im2im_uq_tpu/scripts/router.py``, with the same sweep-YAML
schema, the same order of work and the same artifacts. Per grid point:

  fix randomness → skip if the results pickle exists → build the dataset →
  trunk + uncertainty head → 4-way split → train → validation loss table
  (unshifted λ grid) → RCPS calibration → ``CP_calibrated_*.pt`` → the
  concatenated (N_calib + N_val, L) loss table → image panels → set
  metrics → ``results_*.pkl``.

``results_*.pkl`` holds plain numpy values under the JAX router's keys, and
``loss_table_*.pth`` is a ``pickle.dump`` of the numpy table, as there. The
device comes from ``--device`` (default ``cuda``), never from the config's
``device`` key; with ``--device cuda`` and no CUDA device it raises.

    python -m im2im_uq_tpu_torch.scripts.router \\
        --config experiments/synthetic_test/config.yml [--grid-index 0] \\
        [--data-path DIR] [--output-dir DIR] [--device cuda]

As the JAX router runs over a mesh of every visible device, this one runs
data-parallel over every visible GPU (``CUDA_VISIBLE_DEVICES`` limits
them), one process each (``parallel/``): with ``--device cuda`` and more
than one GPU it starts one worker per GPU itself, and under a launcher
(``python -m torch.distributed.run --nproc_per_node N -m
im2im_uq_tpu_torch.scripts.router ...``) each process joins the group.
Training, the loss tables, calibration and the metrics then run over the
mesh; every rank computes the same results and rank 0 alone writes the
checkpoints, the pickles and the logs. With one GPU the path is the
one-device one.

``on_device_transform: true`` trains FastMRI on raw masked k-space and
TEMCA on raw uint8 patches, with the physics or the pair made inside the
train and validation steps on the device (``device_preprocess`` /
``device_preprocess_pair``, as the ``preprocess`` / ``preprocess_pair``
hooks of ``train_net``); the validation panels, the loss tables,
calibration and the metrics run in image mode, as in the JAX router. Every
other dataset ignores the flag, as there. Not ported: the wandb-agent mode
without ``--config``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional

import numpy as np
import torch

from im2im_uq_tpu_torch.calibration.metrics import eval_set_metrics
from im2im_uq_tpu_torch.calibration.rcps import calibrate_model
from im2im_uq_tpu_torch.data.core import random_split, split_lengths
from im2im_uq_tpu_torch.models.assembly import add_uncertainty, build_trunk
from im2im_uq_tpu_torch.parallel import distributed
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.training.checkpoint import save_calibrated_checkpoint
from im2im_uq_tpu_torch.training.evaluate import get_images, get_loss_table
from im2im_uq_tpu_torch.training.train import PreemptionInterrupt, train_net
from im2im_uq_tpu_torch.utils.config import load_config
from im2im_uq_tpu_torch.utils.logging import MetricsLogger
from im2im_uq_tpu_torch.utils.random import fix_randomness

__all__ = [
    "build_dataset",
    "loss_table_filename",
    "main",
    "results_filename",
    "run_experiment",
    "split_dataset",
]


def _config_key(config: dict) -> str:
    return "_".join([
        config["dataset"],
        config["uncertainty_type"],
        str(config["batch_size"]),
        str(config["lr"]),
        config["input_normalization"],
        config["output_normalization"].replace(".", "_"),
    ])


def results_filename(config: dict) -> str:
    """The JAX router's (and the reference's) results pickle name."""
    return os.path.join(config["output_dir"], f"results_{_config_key(config)}.pkl")


def loss_table_filename(config: dict) -> str:
    """The JAX router's (and the reference's) loss-table dump name."""
    return os.path.join(config["output_dir"], f"loss_table_{_config_key(config)}.pth")


def build_dataset(config: dict):
    """Dataset dispatch to the port's data classes (``data/``, copies of
    the JAX package's). Data locations come from ``config['data_path']``."""
    name = config["dataset"]
    path = config.get("data_path")
    if path:
        path = os.path.expanduser(path)
    if name == "synthetic":
        from im2im_uq_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(
            num_examples=config.get("num_examples", 128),
            image_size=config.get("image_size", 64),
            num_channels_in=config.get("num_inputs", 1),
            seed=config.get("seed", 0),
        )
    if name == "CIFAR10":
        from im2im_uq_tpu_torch.data.cifar10 import CIFAR10Dataset

        return CIFAR10Dataset(path, seed=config.get("seed", 0))
    if name == "fastmri":
        from im2im_uq_tpu_torch.data.fastmri import FastMRIDataset
        from im2im_uq_tpu_torch.data.normalize import normalize_dataset

        mask_info = config.get(
            "mask_info",
            {"type": "equispaced", "center_fraction": [0.08], "acceleration": [4]},
        )
        ds = FastMRIDataset(
            path,
            normalize_input=config["input_normalization"],
            normalize_output=config["output_normalization"],
            mask_info=mask_info,
            num_volumes=config.get("num_volumes"),
            slice_sample_period=config.get("slice_sample_period", 1),
        )
        ds = normalize_dataset(ds)
        config.update(ds.norm_params)
        return ds
    if name == "temca":
        from im2im_uq_tpu_torch.data.temca import TEMCADataset

        side = config["side_length"]
        down = config["downsampling_factor"]
        return TEMCADataset(
            path,
            patch_size=(side, side),
            downsampling=(down, down),
            buffer_size=config["num_buffer"],
            normalize="01",
        )
    if name == "bsbcm":
        from im2im_uq_tpu_torch.data.bsbcm import BSBCMDataset

        return BSBCMDataset(path, num_instances="all", normalize=config["output_normalization"])
    raise NotImplementedError(f"unknown dataset {name!r}")


def split_dataset(dataset, config: dict, rng: np.random.RandomState):
    """4-way split; TEMCA splits by partitioning tile paths."""
    pcts = config["data_split_percentages"]
    if config["dataset"] == "temca":
        return dataset.split_by_paths(pcts, rng)[:3] + (None,)
    lengths = split_lengths(len(dataset), pcts)
    return tuple(random_split(dataset, lengths, rng))


def resolve_device(name: str) -> torch.device:
    """The ``--device`` argument as a torch device; CUDA must be present."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch sees no CUDA device")
    return device


class _RawMode:
    """``on_device_transform``: the hook that the dataset's class carries
    (FastMRI: ``device_preprocess`` over ``return_kspace``; TEMCA:
    ``device_preprocess_pair`` over ``return_raw`` on its train and val
    copies, which ``split_by_paths`` deep-copies) and the switch between the
    raw items that training reads and the image items of everything else.
    Other datasets get neither hook and never switch."""

    def __init__(self, config: dict, dataset, train_ds, val_ds, crop: tuple[int, int]):
        self.preprocess = self.preprocess_pair = None
        self.targets: list = []
        self.attr = None
        if not config.get("on_device_transform"):
            return
        if hasattr(dataset, "device_preprocess"):
            self.preprocess = dataset.device_preprocess(crop)
            self.attr, self.targets = "return_kspace", [dataset]  # the splits delegate to it
        elif hasattr(dataset, "device_preprocess_pair"):
            self.preprocess_pair = dataset.device_preprocess_pair()
            self.attr = "return_raw"
            self.targets = [d for d in (train_ds, val_ds) if hasattr(d, "return_raw")]

    def set(self, raw: bool) -> None:
        for d in self.targets:
            setattr(d, self.attr, raw)


def run_experiment(config: dict, device: torch.device | str = "cuda",
                   mesh: Optional[mesh_lib.Mesh] = None) -> Optional[dict]:
    """One grid point end to end on ``device``; returns the results dict
    (or None when its results pickle already exists).

    Over ``mesh`` (by default the mesh of every rank when this process is
    one of a group, as the JAX router defaults to every device) the grid
    point runs data-parallel on ``mesh.device``; rank 0 writes."""
    mesh_lib.check_mesh(mesh)
    if mesh is None and distributed.process_shard_info()[1] > 1:
        mesh = mesh_lib.data_parallel_mesh(device)
    if mesh is not None:
        device = mesh.device
    writes = mesh is None or mesh.is_main
    seed = config.get("seed", 0)
    generator = fix_randomness(seed)
    if config.get("output_dir"):
        os.makedirs(config["output_dir"], exist_ok=True)
        fname = results_filename(config)
        done = os.path.exists(fname)
        if mesh_lib.spans(mesh):
            done = mesh.agree(done)  # every rank skips, or none
        if done:
            print(f"Results already precomputed and stored in {fname}!")
            return None
    else:
        fname = None
    print("Computing the results from scratch!")

    logger = MetricsLogger(config.get("output_dir") if writes else None, config=config)
    dataset = build_dataset(config)
    train_ds, calib_ds, val_ds, _ = split_dataset(dataset, config, np.random.RandomState(seed))
    # the first training item in image mode, drawn as the JAX router draws
    # its example input (the same random numbers: a fresh FastMRI mask, a
    # TEMCA buffer fill); its target's size is the k-space crop
    _, y0 = train_ds[0] if hasattr(train_ds, "__getitem__") else next(iter(train_ds))
    state = add_uncertainty(build_trunk(config), config, generator=generator, device=device)
    raw = _RawMode(config, dataset, train_ds, val_ds, np.asarray(y0).shape[:2])
    raw.set(True)

    def validation_hook(current_state, epoch, global_step):
        # per-validation image panels; a failure here must not end training
        try:
            raw.set(False)  # the panels show image-domain inputs
            panels = get_images(
                current_state, val_ds, list(range(config["num_validation_images"])), config
            )["panels"]
            for tag, imgs in panels.items():
                logger.log_images(tag, imgs, step=epoch)
        except Exception as e:
            print(f"Failed logging images. ({e})")
        finally:
            raw.set(True)

    try:
        state = train_net(
            state,
            train_ds,
            val_ds,
            mesh,
            epochs=config["epochs"],
            batch_size=config["batch_size"],
            lr=config["lr"],
            load_from_checkpoint=config.get("load_from_checkpoint", False),
            checkpoint_dir=config.get("checkpoint_dir"),
            checkpoint_every=config.get("checkpoint_every", 1),
            validate_every=config.get("validate_every", 10),
            config=config,
            logger=logger,
            validation_hook=validation_hook,
            preprocess=raw.preprocess,
            preprocess_pair=raw.preprocess_pair,
        )
    except PreemptionInterrupt as e:
        # graceful_shutdown saved a resumable checkpoint; exit with the
        # conventional SIGTERM status so schedulers see a clean preemption
        print(e)
        raise SystemExit(143)
    raw.set(False)  # calibration, evaluation and artifacts read image items
    print("Done training!")

    print("Get the validation loss table.")
    val_loss_table = get_loss_table(state, val_ds, config, mesh=mesh)
    print("Calibrate the model.")
    state, calib_loss_table = calibrate_model(state, calib_ds, config, mesh=mesh)
    print(f"Model calibrated! lambda hat = {state.lhat}")

    if config.get("checkpoint_dir") and writes:
        cal_path = save_calibrated_checkpoint(state, config, config["checkpoint_dir"])
        print(f"Calibrated checkpoint saved: {cal_path}")

    if config.get("output_dir") and writes:
        table = np.concatenate([calib_loss_table, val_loss_table], axis=0)
        with open(loss_table_filename(config), "wb") as fh:
            pickle.dump(table, fh, protocol=pickle.HIGHEST_PROTOCOL)
        print("Loss table saved!")

    images = get_images(state, val_ds, list(range(config["num_validation_images"])), config)
    for tag, imgs in images["panels"].items():
        logger.log_images(tag, imgs, step="final")

    print("GET THE METRICS INCLUDING SPATIAL MISCOVERAGE")
    metrics = eval_set_metrics(state, val_ds, config, mesh=mesh)
    print(
        f"Risk: {metrics.risk}  |  Mean size: {metrics.sizes.mean()}  |  "
        f"Spearman: {metrics.spearman}  |  Size-stratified risk: {metrics.stratified_risks} | "
        f"MSE: {metrics.mse}"
    )
    logger.log(
        {
            "epoch": config["epochs"] + 1,
            "risk": metrics.risk,
            "mean_size": float(metrics.sizes.mean()),
            "Spearman": metrics.spearman,
            "Size-Stratified Risk": metrics.stratified_risks,
            "mse": metrics.mse,
        }
    )

    results = {
        "risk": metrics.risk,
        "sizes": metrics.sizes,
        "spearman": metrics.spearman,
        "size-stratified risk": metrics.stratified_risks,
        "mse": metrics.mse,
        "spatial_miscoverage": metrics.spatial_miscoverage,
        "lhat": state.lhat,
    }
    results.update(images["raw"])
    if fname is not None and writes:
        with open(fname, "wb") as fh:
            pickle.dump(results, fh, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"Results saved to file {fname}!")
    logger.close()
    return results


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True, help="sweep YAML (wandb schema ok)")
    parser.add_argument("--grid-index", type=int, default=None)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    rc, mesh = distributed.join_or_spawn("im2im_uq_tpu_torch.scripts.router", argv, device)
    if rc is not None:
        return rc  # the workers, one per GPU, ran every grid point
    grid = load_config(args.config, args.grid_index)
    print(f"{len(grid)} grid point(s).")
    for i, config in enumerate(grid):
        if args.data_path:
            config["data_path"] = args.data_path
        if args.output_dir:
            config["output_dir"] = args.output_dir
        print(f"--- grid point {i}: {config['uncertainty_type']}, lr={config['lr']} ---")
        run_experiment(config, device, mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
