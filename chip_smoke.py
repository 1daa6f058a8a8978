#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. env        versions of torch, CUDA and nvcc; the card's name and power
              limit; TF32 switched off for convolutions and matmuls.
2. build      compile ``im2im_uq_tpu_torch/csrc/*.cu`` (timed).
3. k1         the upsample kernel against its plain PyTorch version on the
              card, at the four decoder shapes of a batch-32 320x320 UNet
              and some odd shapes, in f32 and bf16 (0 outputs apart, bit
              for bit: the TPU kernel's bf16 rounding), the same bits
              twice, with both times, summed over the three shapes a step
              launches (K1_STEP_SHAPES); the bf16 sums on a k1_bf16_sums
              line (so k1b and k7). k1_plan: the bf16 kernels' plan as the
              library computes it against ``upsample.upsample_plan``;
              k1_one_column: the bf16 kernel one column a thread at one
              decoder shape, bit for bit with the vector instance, timed.
              k1_route: up1's input (32, 512, 20, 20), which the TPU
              kernel does not take, routed to the XLA form in f32 and bf16
              (output and gradient equal to ``upsample2x_xla``'s, no K1
              launch); every UNet or WNet train step launches K1f and K1b
              3 times.
   k1b        the upsample's backward kernel against its plain version at
              the four decoder cotangent shapes and the odd shapes, both
              dtypes (bf16 within one ulp and bit for bit), the same bits
              twice, with both times; k1b_one_column as k1's.
4. k2         the loss-table kernel against its plain version, 0 cells
              apart and the same bits twice, at (32, 102400) and L=1000 on
              the calibration grid and on edge grids (unsorted, duplicates,
              negative, ±0, NaN, ±inf; slopes of both signs, ±0, ±inf, NaN;
              exact ties), the same at an odd P and at L=20000, with both
              times.
   k7         the max-pool backward kernel against its plain version and
              against autograd of ``F.max_pool2d``, bit for bit, at the four
              pool inputs of the batch-32 320x320 UNet and of WNet, odd
              shapes and tied
              windows, both dtypes, with both times.
   k3..k6     the 3x3 conv kernels (K3 conv, K4 fused conv, K5 wgrad, K6
              dgrad) against their plain versions at every conv shape of a
              batch-32 320x320 UNet train step under ``pallas_fused`` and
              ``pallas``, WNet's step under ``pallas_fused`` (untimed),
              odd shapes and batch 1; each run twice, bit for
              bit; kernel, plain, library and bound times at the main-path
              shapes, summed per step; then one conv_shape line per
              main-path shape with the K3-K6 times side by side (the stem
              marked). Each k5 line names its path: every main-path shape
              but the stem, and K5_TMA_ODD_SHAPES, must take the f32 TMA
              path (``csrc/wgrad3x3_tma.cu``, counted on ``wgrad3x3.tma``);
              there the mma.sync kernel (``conv_bwd.wgrad3x3_mma_sync``) is
              held to the same bars and timed in turns with it
              (``mma_sync_ms``); a k5_step line sums the step's launches on
              the TMA path (ms, mma.sync, library, bound, the 3xTF32 direct
              floor). Each k6 line names its path likewise: every main-path
              shape and K6_TMA_ODD_SHAPES must take K6's f32 TMA path
              (``csrc/dgrad3x3_tma.cu``, counted on ``dgrad3x3.tma``), beside
              which the cp.async kernel (``conv_bwd.dgrad3x3_cp_async``) is
              held to the bars and timed in turns (``cp_async_ms``); a
              k6_step line sums the step's 13 launches. The fused train
              step must launch K5 14 times a step, 13 of them on the TMA
              path, and K6 13 times, all on its TMA path.
   conv3x3_bf16, conv3x3_bn_act_bf16
              the bf16 instances of K3 and K4 against their plain versions
              at every conv launch of the bf16 paths (the ``pallas`` train
              step's forward, the ``pallas_fused`` eval forward) and the
              odd shapes, within ``conv_probe.bf16_tolerance``, the same
              bits twice; kernel, plain, library (``F.conv2d`` in bf16)
              and bound times.
   cotangent_bf16, k5_bf16, k6_bf16
              the bf16 backward of K4: the cotangent pass (the stats'
              terms added, written NHWC once for both kernels) bit for bit,
              and K5 and K6 on wgmma reading it, against their plain
              versions at every launch of the bf16 ``pallas_fused`` train
              step and the odd shapes, prologue on and off, the same bits
              twice; kernel, plain, library (``torch.nn.grad.conv2d_weight``
              / ``conv2d_input`` in bf16; none for the cotangent pass) and
              bound times, per shape and summed per step.
   probes     P1 (per-channel moments) and P2-P5 (bias-free NHWC 3x3
              conv), the ports of the Pallas probes of ``benchmarks/``,
              against their plain versions in f32 and bf16 at the probes'
              default shape (which must take the f32 TMA path), at the
              shapes their CLIs run (which must take the bf16 TMA path)
              and at odd shapes (ragged tiles, Cin and Cout 4 to 200,
              several N slices; Cin 3 and 5, Cout 6 and 7 on the cp.async
              path), each run twice, bit for bit; each line names its
              path; kernel, plain, library and bound times in both dtypes,
              and in f32 the cp.async path's time beside the TMA path's
              (``probes_f32`` lines).
   probe_cli  the probes' CLIs (``scripts.bench_moments`` and
              ``scripts.bench_conv3x3`` at Cin 64, 128 and 96, and its f32
              ``--check``), which must launch P1-P5 in both dtypes.
5. calibrate  the full-width UNet + quantile head (random weights from a
              seed) calibrated on 128 synthetic 320x320 images, L=1000.
6. serve      save the calibrated checkpoint, run ``scripts/infer.main`` on
              64 more images, check the intervals.
7. crosscheck the same model at batch 2 on the CPU (plain versions) and on
              the card, nested sets compared.
8. train      the full-width model at 320x320, batch 32, fp32: first
              ``make_train_step`` on one batch (every parameter's first
              gradient checked, the device time of 8 steps after 2
              warm-ups), then ``train_net`` from the same initial weights
              for one epoch of 384 synthetic images (12 steps) and its
              validation, with the launches of K1f, K1b and K7.
9. router     ``scripts/router.main`` on a copy of
              ``experiments/synthetic_test/config.yml`` writing to a
              temporary directory: artifacts, results keys, λ̂, launches.
10. gradcheck one train step of the phase-8 initial weights at batch 2,
              64x64: on the card with the kernels against the card with
              their plain versions (bit for bit), and against the CPU in
              f32 and f64: gradients and BatchNorm running statistics.
11. fused     the same model under ``conv_backend: pallas_fused`` at
              320x320, batch 32: ``make_train_step`` (first gradients, the
              step time), one step and the eval forward against the default
              (cuDNN) config from the same weights, then calibrate and serve
              as in phases 5-6 (fused_calibrate, fused_serve).
12. pallas    ``conv_backend: pallas``: one train step and the eval forward
              against the default config.
13. router    the router again, on the synthetic experiment with
              ``conv_backend: pallas_fused`` (router_fused).
14. heads     each of the gaussian, residual_magnitude,
              residual_magnitude_l1 and softmax (50 classes) heads on the
              main path's UNet at 320x320, batch 32: 5 train steps, the
              gradcheck of phase 10 (heads_gradcheck), calibration of the
              trained model on the 128 images, serving of the 64, and K2 on
              the head's own interval params against its plain version
              (heads_k2: 0 cells apart, the same bits twice; zero slopes
              counted); one ``heads`` line per head with its median step
              ms, calibration seconds, serving images/s and λ̂.
15. wnet      WNet + quantile head on 2-channel 320x320 inputs, batch 32:
              5 train steps under ``xla``, then under ``pallas_fused``
              (K3-K6 launched; the step and the eval forward against the
              default config's), calibration and serving under both.
16. router    the router with ``uncertainty_type: softmax``
              (router_softmax), whose λ grid and default λ differ.
17. bf16      ``compute_dtype: bfloat16`` on the main path's model at
              320x320, batch 32: 5 train steps, calibration and serving
              under ``xla``, ``pallas`` and ``pallas_fused`` (K5/K6 in
              bf16); calibration and serving under ``pallas_fused`` of
              weights trained in f32; the eval forward of those weights
              under each backend against the f32 one.
18. bf16_gradcheck one bf16 ``pallas_fused`` train step at batch 2, 64x64
              with the kernels against the plain versions on the card, and
              both against the CPU's f64 step.
19. bf16_models one bf16 eval forward of each other head and of WNet
              under each backend, against the f32 forward.
20. router    the router in bf16 (router_bf16), and in bf16 under
              ``pallas_fused`` (router_bf16_fused).
21. remat     ``remat`` full, conv and bn at 320x320, batch 32, under
              ``xla`` in f32 and ``pallas_fused`` in bf16: one step's loss,
              gradients and statistics against remat off, the peak of
              device memory and the step time beside remat off's.
22. deploy    the seed-0 weights of phase 5, saved as an uncalibrated
              training checkpoint, calibrated by ``scripts/calibrate.main``
              on the 128 images under the default config (calibrate_cli)
              and under ``pallas_fused`` (calibrate_cli_fused): λ̂ and the
              table bit for bit those of ``calibrate_model`` on the same
              state and data, K2 and K1f (and K3/K4) launched. Then
              ``scripts/export_serving.main`` on the calibrated checkpoint,
              traced on the card and stored on the CPU (export), and
              ``infer.main --artifact`` on the 64 serve images
              (artifact_serve): no port kernel launched, the intervals
              those of ``infer.main --config --checkpoint`` under the
              "xla" backends bit for bit (else within rtol 1e-6 / atol
              1e-7, the JAX artifact test's bars), and the default
              config's (K1f) within phase 7's rtol 1e-4 / atol 1e-5; the
              same export and serving once in bf16. Then ``export_torch.main``
              on the calibrated checkpoint and ``import_torch.main`` on its
              reference-layout ``.pth`` (interop): the keys the model's and
              ``lhat``, the imported weights and λ̂ the checkpoint's, the
              intervals served from the imported checkpoint bit for bit
              the default config's.
23. data_device the on-device input transforms at full width. fastMRI
              singlecoil knee: 160 slices made from a seed on the host (k-space
              640x368, the router's default mask, equispaced, center fraction
              0.08, 4x; targets 320x320), normalised as the dataset does; the
              raw items' shape (32, 640, 368, 2); ``zero_filled_recon`` on
              the card against the host ``UnetDataTransform`` and the dataset's
              closure against the image items (rtol 2e-4, atol 1e-5); step 1
              with the hook against the image-mode step on the host's
              inputs (RAW_LOSS_RTOL); 5 train steps with the hook under the
              default config and under ``pallas_fused`` beside 5 in image
              mode (K1f, K1b, K7, and K3-K6 under ``pallas_fused``); image-mode
              calibration on 128 slices (K2); then, where h5py is installed,
              the router with ``on_device_transform: true`` on two synthetic
              HDF5 volumes at that geometry, else ``train_net`` with the hook
              on the slices in memory, the hook's inputs recorded. TEMCA at
              ``side_length`` 320, ``downsampling_factor`` 4, batch 16: uint8
              patches from the seed, the raw feed (one uint8 patch an item),
              ``device_preprocess_pair`` on the card bit for bit the host's
              pair, step 1 bit for bit the image-mode step's, 5 steps with the
              hook beside 5 in image mode. Each line gives the transform's ms
              a batch (CUDA events after warm-up), the bytes a batch moves
              host to device raw and in image mode, the median step ms in
              each mode and the launches.
24. midepoch  ``input_pipeline: grain`` at full width under ``pallas_fused``
              f32 with deterministic cuDNN: 256 synthetic images (8 steps an
              epoch), 2 epochs, ``checkpoint_every_steps: 3``,
              ``graceful_shutdown``. Run A uninterrupted; run B stopped by
              SIGTERM while step 5's batch is read (the mid-epoch file holds
              ``{"next_index": 5}``), then resumed from it: weights,
              BatchNorm statistics, Adam's state and both epochs' losses bit
              for bit A's; K1f/K1b 3 a step, K5/K6 a fixed number a step;
              one save's seconds and the file's MB.
25. multistep ``make_train_multistep``, 10 steps captured as one CUDA graph,
              at full width under ``pallas_fused`` f32, ``pallas_fused``
              bf16 and ``xla`` with ``pool_backend: pallas``, deterministic
              cuDNN: the replay's final state and last loss against 10 eager
              steps of the same capturable step, bit for bit (else the
              largest difference is printed and the phase fails), each
              port kernel's launches in one replay (``torch.profiler``, the most over two
              sessions, since CUPTI drops a record at times) 10 times one
              eager step's, ms a step eager and replayed (CUDA events,
              median and spread), the graph's peak memory, and the default
              (not capturable) Adam's steps beside the capturable one's.
26. resnet    ResNet18 + quantile head at 32x32, batch 32: 5 train steps
              (every first gradient finite and nonzero; no port kernel on
              the trunk's path), calibration on 256 images (K2).
27. dp        the multi-GPU API over the ranks of one process group (the
              port's ``parallel/``): one rank per visible GPU over NCCL
              with two or more GPUs, else two ranks on the one card over
              gloo (its own CUDA collectives), a rehearsal that gives no
              scaling number.
              The main path's model at 320x320, a global batch of 32: one
              SGD step under ``xla`` f32,
              ``pallas_fused`` f32 and ``pallas_fused`` bf16 against the
              one-process step on rank 0's card (dp_train: loss, gradients,
              parameters and running statistics, the f32 ones within the
              CPU test's bars; each rank's K1f, K1b, K7 and K3-K6
              launches; the median and min-max spread of DP_TIMED_STEPS
              DP steps, each timed, beside the one-process step on the
              whole batch and on rank 0's shard); calibration of the phase-5
              weights under ``pallas_fused`` on the 128 images sharded
              (dp_calibrate: the calibrated table and the whole table over
              the mesh within DP_TABLE_ATOL of one process's, λ̂ equal,
              ``compute_risks_device`` within 1e-6 of the whole table's
              column means, over the mesh and in one process; the
              calibration's launches and compute_risks_device's, each
              counted alone); ``infer.main --data-parallel`` on the 64
              serve images (dp_serve: the intervals against one process).
              Then the multi-GPU API beyond it: the serving artifact
              exported with ``--n-devices`` equal to the ranks and served
              by ``infer.main --artifact`` over them (dp_artifact: against
              the one-process artifact, bits and gap; no port kernel);
              ``infer.main --spatial`` on two 648x640 tiles under ``xla``
              and ``pallas_fused`` in f32 and bf16 and under
              ``resize_backend: pallas`` (spatial: the gap to the
              one-process intervals, within dp_serve's 1e-4 in f32, and in
              bf16 no farther from the one-process f32 intervals than 1.5
              times the one-process bf16 ones; each rank's launches equal to
              the one-process run's but for K1f, which runs only under
              ``resize_backend: pallas``, over the gathered height); and
              ``training/multiseed.py`` with two seeds a rank, one Adam
              step of batch 32 under ``pallas_fused`` f32 (multiseed: each
              replica against the one-process step of its seed on the same
              card, launches equal to those steps'). Last
              ``make_train_multistep`` over the ranks (dp_multistep): over
              NCCL the three configs of phase 25 at the global batch of 32,
              each rank's 10 mesh steps captured as one CUDA graph with
              their collectives, the replay bit for bit 10 eager mesh steps
              on every rank and every rank the same bits, each port
              kernel's launches in one replay 10 times an eager mesh
              step's, ms a step eager and replayed and the peak memory of
              each; over gloo (one card) the call must raise the
              ValueError that names NCCL, and the line says that no graph
              was captured and why. Each line gives the
              gap to one process, whether the bits match, and each rank's
              launches. ``python3 chip_smoke.py --dp-worker DIR`` is a rank;
              ``python3 chip_smoke.py --dp-only`` runs env, build and this
              phase alone.

The kernel launch counters are set to 0 just before each path that a user
runs (the probe CLIs, calibrate + serve, train, router, each of them
under the fused config, each head's, WNet's and the softmax router's, the
bf16 paths, the remat steps, the calibrate CLI and the serving paths of
the deploy phase, the data_device phase's raw train steps, calibration and
train_net or router, and in each rank the dp phase's steps, calibration,
``compute_risks_device``, serving, the artifact, each spatial case, the
multi-seed step and each multistep capture) and read just after it; the ``kernels`` line
reports the sum over those paths. Any failure raises and the script exits
non-zero. The line before the last is ``nvidia-smi``'s name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import datetime
import gc
import io
import json
import math
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.calibration.rcps import (
    calibrate_model,
    compute_loss_table,
    compute_risks_device,
    lambda_grid,
)
from im2im_uq_tpu_torch.data.core import Subset
from im2im_uq_tpu_torch.data.fastmri import FastMRIDataset
from im2im_uq_tpu_torch.data.grain_pipeline import make_grain_dataset
from im2im_uq_tpu_torch.data.normalize import normalize_dataset
from im2im_uq_tpu_torch.data.subsample import create_mask_for_mask_type
from im2im_uq_tpu_torch.data.temca import TEMCADataset
from im2im_uq_tpu_torch.data.transforms import (
    UnetDataTransform,
    apply_mask,
    fft2c_np,
    to_real_pair,
)
from im2im_uq_tpu_torch.models.assembly import (
    UQState,
    add_uncertainty,
    build_trunk,
    nchw_from_nhwc,
)
from im2im_uq_tpu_torch.models.heads import head_loss_pe_fn
from im2im_uq_tpu_torch.ops import (
    conv,
    conv_bwd,
    conv_probe,
    loss_table,
    moments,
    pool,
    resize,
    upsample,
)
from im2im_uq_tpu_torch.ops.mri_pipeline import zero_filled_recon
from im2im_uq_tpu_torch.parallel import distributed
from im2im_uq_tpu_torch.parallel import mesh as mesh_lib
from im2im_uq_tpu_torch.parallel import spatial
from im2im_uq_tpu_torch.scripts import bench_conv3x3, bench_moments, infer, router
from im2im_uq_tpu_torch.scripts import calibrate as calibrate_script
from im2im_uq_tpu_torch.scripts import export_serving, export_torch, import_torch
from im2im_uq_tpu_torch.training import multiseed, train
from im2im_uq_tpu_torch.training.checkpoint import (
    calibrated_checkpoint_path,
    checkpoint_path,
    save_calibrated_checkpoint,
    save_checkpoint,
    save_midepoch_checkpoint,
)
from im2im_uq_tpu_torch.utils import profiling
from im2im_uq_tpu_torch.utils.timing import time_ms

DECODER_SHAPES = [(32, 512, 20, 20), (32, 256, 40, 40), (32, 128, 80, 80), (32, 64, 160, 160)]
ODD_SHAPES = [(2, 3, 1, 1), (1, 5, 1, 7), (3, 7, 9, 1), (2, 4, 13, 17), (1, 2, 33, 5)]

CONFIG = {
    "model": "UNet",
    "uncertainty_type": "quantiles",
    "q_lo": 0.05,
    "q_hi": 0.95,
    "alpha": 0.1,
    "delta": 0.1,
    "num_lambdas": 1000,
    "minimum_lambda": 0.0,
    "maximum_lambda": 6.0,
    "rcps_loss": "fraction_missed",
    "batch_size": 32,
    "dataset": "synthetic",
    "lr": 1e-3,
}
CALIB_N, SERVE_N, IMAGE = 128, 64, 320
POOL_SHAPES = [(32, 64, 320, 320), (32, 128, 160, 160), (32, 256, 80, 80), (32, 512, 40, 40)]
POOL_ODD_SHAPES = [(2, 3, 5, 7), (1, 2, 1, 9)]
TRAIN_N, TRAIN_VAL_N, WARMUP_STEPS, TIMED_STEPS = 384, 32, 2, 8
# gradcheck tolerances, relative L2 per tensor (see phase_gradcheck)
GRAD_RTOL, STAT_RTOL = 1e-2, 1e-5
ROUTER_CONFIG = Path(__file__).resolve().parent / "experiments" / "synthetic_test" / "config.yml"
# the keys of the JAX router's results pickle (im2im_uq_tpu/scripts/router.py:299-308)
RESULT_KEYS = sorted([
    "risk", "sizes", "spearman", "size-stratified risk", "mse", "spatial_miscoverage",
    "lhat", "inputs", "gt", "predictions", "lower_edge", "upper_edge",
])
# where phases 8-10 and the single-process CLIs run the port: an indexed
# device, so that the router and the calibrate and infer CLIs run in this
# process on one GPU also where more are visible (with plain "cuda" they
# would start one worker per GPU)
DEVICE = "cuda:0"
# each kernel's wrapper, which counts its launches
KERNELS = {
    "upsample2x": upsample.upsample2x,
    "upsample2x_bwd": upsample.upsample2x_bwd,
    "loss_table": loss_table.loss_table,
    "maxpool2x2_bwd": pool.max_pool2x2_bwd,
    "conv3x3": conv.conv3x3,
    "conv3x3_bn_act": conv.conv3x3_bn_act,
    # the bf16 instances of K3-K6, counted apart
    "conv3x3_bf16": conv.conv3x3.bf16,
    "conv3x3_bn_act_bf16": conv.conv3x3_bn_act.bf16,
    "wgrad3x3": conv_bwd.wgrad3x3,
    # the f32 K5 launches on wgmma with TMA (csrc/wgrad3x3_tma.cu), also
    # counted on wgrad3x3
    "wgrad3x3_tma": conv_bwd.wgrad3x3.tma,
    "dgrad3x3": conv_bwd.dgrad3x3,
    # the f32 K6 launches on wgmma with TMA (csrc/dgrad3x3_tma.cu), also
    # counted on dgrad3x3
    "dgrad3x3_tma": conv_bwd.dgrad3x3.tma,
    "wgrad3x3_bf16": conv_bwd.wgrad3x3.bf16,
    "dgrad3x3_bf16": conv_bwd.dgrad3x3.bf16,
    "cotangent_nhwc": conv_bwd.cotangent_nhwc,
    "activation_nhwc": conv_bwd.activation_nhwc,
    "moments": moments.moments,
    "conv3x3_single": conv_probe.conv3x3_single,
    "conv3x3_db": conv_probe.conv3x3_db,
    "conv3x3_l1": conv_probe.conv3x3_l1,
    "conv3x3_c64": conv_probe.conv3x3_c64,
    # P2-P5's float32 launches, counted apart
    "conv3x3_single_f32": conv_probe.conv3x3_single.f32,
    "conv3x3_db_f32": conv_probe.conv3x3_db.f32,
    "conv3x3_l1_f32": conv_probe.conv3x3_l1.f32,
    "conv3x3_c64_f32": conv_probe.conv3x3_c64.f32,
}
PROBE_CONV_KERNELS = ["conv3x3_single", "conv3x3_db", "conv3x3_l1", "conv3x3_c64"]
PROBE_KERNELS = (["moments"] + PROBE_CONV_KERNELS
                 + [f"{name}_f32" for name in PROBE_CONV_KERNELS])
DEFAULT_PATH_KERNELS = ["upsample2x", "upsample2x_bwd", "loss_table", "maxpool2x2_bwd"]
CONV_KERNELS = ["conv3x3", "conv3x3_bn_act", "wgrad3x3", "dgrad3x3"]
CONV_PHASES = dict(zip(CONV_KERNELS, ["k3", "k4", "k5", "k6"]))
# The DoubleConvs of the 320x320 UNet as (Cin, mid, Cout, side, in an Up):
# an Up's conv0 reads the concatenation of two halves of Cin // 2 channels
DOUBLE_CONVS = [
    (1, 64, 64, 320, False), (64, 128, 128, 160, False), (128, 256, 256, 80, False),
    (256, 512, 512, 40, False), (512, 512, 512, 20, False),
    (1024, 512, 256, 40, True), (512, 256, 128, 80, True), (256, 128, 64, 160, True),
    (128, 64, 64, 320, True),
]
# WNet's DoubleConvs at 320x320: two encoders of 32/64/128/256/256 channels,
# then the UNet's decoder
WNET_DOUBLE_CONVS = [
    (1, 32, 32, 320, False), (32, 64, 64, 160, False), (64, 128, 128, 80, False),
    (128, 256, 256, 40, False), (256, 256, 256, 20, False),
] * 2 + DOUBLE_CONVS[5:]
# the inputs of WNet's pools (each encoder's four)
WNET_POOL_SHAPES = [(32, 32, 320, 320), (32, 64, 160, 160), (32, 128, 80, 80), (32, 256, 40, 40)]
# the heads of the heads phase, beside the main path's quantiles; softmax
# with the shipped configs' 50 classes
HEAD_TYPES = ["gaussian", "residual_magnitude", "residual_magnitude_l1", "softmax"]
NUM_SOFTMAX = 50
# train steps of the heads and wnet phases, each timed (CUDA events)
PATH_STEPS = 5
# the heads whose gradcheck holds the card to the CPU in f64 (phase_gradcheck)
F64_GRADCHECK_HEADS = ["gaussian"]
# (B, Cin, H, W, Cout): Cin 1, 3 and 64, 1x1, 5x7 and 13x17, batch 1
CONV_ODD_SHAPES = [(2, 1, 1, 1, 8), (1, 3, 5, 7, 16), (2, 64, 13, 17, 24), (1, 1, 13, 17, 64),
                   (1, 64, 5, 7, 64), (1, 128, 160, 160, 128)]
# K5's cases beyond those, on its f32 TMA path (csrc/wgrad3x3_tma.cu): a
# 20-wide image in chunks of 24 columns with Cout 24 (one ragged N tile),
# W 44 in chunks of 48 with 27 row groups over two M tiles and Cout 72 over
# two N tiles, Cin 16 at W 12 over strips of 16
K5_TMA_ODD_SHAPES = [(2, 32, 13, 20, 24), (1, 48, 9, 44, 72), (3, 16, 7, 12, 8)]
# K6's cases on its f32 TMA path (csrc/dgrad3x3_tma.cu), Cin at the plan's
# smallest multiple (64) but in one: W 20 in tiles of 13 x 12 (the second
# 8 columns wide) over 3 chunks of Cout 24; H 21 in tiles of 12 x 20 (the
# last 9 rows: a short last box); a 1 x 4 image, smaller than its box;
# three N slices of Cin 192 with Cout 40 in 5 chunks; tiles of 16 x 16
# over a 30 x 28 image (the last ones 14 rows and 12 columns)
K6_TMA_ODD_SHAPES = [(2, 64, 13, 20, 24), (3, 64, 21, 40, 16), (1, 64, 1, 4, 8),
                     (2, 192, 17, 36, 40), (2, 64, 30, 28, 8)]
# Bars of a conv kernel against its plain version, on the relative L2
# error and on max|error| / max|plain|: both sum in f32 in another order,
# over 9*Cin terms (K3, K4's y, K6's dx: 3e-5) or over B*H*W terms (K5,
# K4's stats, K6's reductions: 1e-4); a wrong tap or mask is off by order 1.
CONV_TOL, SUM_TOL = 3e-5, 1e-4
# the fused config's step against the default config's, same weights: the
# running statistics come from the forward alone; the eval forward too
FUSED_STAT_RTOL, FUSED_EVAL_RTOL, FUSED_LOSS_RTOL = 1e-4, 1e-4, 1e-4
# H100 SXM data sheet: fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
# f32-accurate products on the tensor cores: TF32's 495 TFLOP/s (data
# sheet, dense) over the three passes of 3xTF32 (hi·hi + hi·lo + lo·hi)
PEAK_F32_TC_FLOPS = 495e12 / 3
# bf16 products on the tensor cores, f32 accumulation (H100 SXM data sheet,
# dense)
PEAK_BF16_TC_FLOPS = 989e12
# a bf16 model's eval output against the f32 model's on the same weights,
# relative L2: bf16 rounding through 20 layers (3e-3 on the CPU at 128²,
# tests/test_torch_port_bf16.py)
BF16_EVAL_RTOL = 2e-2
# the kernel launches that each bf16 eval path (calibration, serving) must
# make, beside K2 and K1f: K3/K4 in bf16 beyond the stem run on the
# activation pass's NHWC copy of their input
BF16_KERNELS = {"xla": [], "pallas": ["conv3x3_bf16", "activation_nhwc"],
                "pallas_fused": ["conv3x3_bf16", "conv3x3_bn_act_bf16", "activation_nhwc"]}
# ... and each bf16 train path, beside K1f, K1b and K7: under pallas_fused
# the backward of every K4 is the cotangent pass, K5 and K6 in bf16
BF16_TRAIN_KERNELS = dict(BF16_KERNELS, pallas_fused=BF16_KERNELS["pallas_fused"]
                          + ["cotangent_nhwc", "wgrad3x3_bf16", "dgrad3x3_bf16"])
# K1f and K1b launches of a UNet or WNet train step at 320x320: the TPU
# kernel's routing leaves up1 (a 20x20 input) to the XLA form
K1_PER_STEP = 3
# up1's input at batch 32, 320x320
UP1_SHAPE = (32, 512, 20, 20)
# the K1f / K1b launches of a step: the decoder shapes but up1's
K1_STEP_SHAPES = [s for s in DECODER_SHAPES if s != UP1_SHAPE]
# where the bf16 K1 kernels are also timed one column a thread
K1_ONE_COLUMN_SHAPE = (32, 128, 80, 80)
# a bf16 train step with the kernels against the same step with their plain
# versions on the card (phase_bf16_gradcheck), relative: the loss, the whole
# gradient (L2 over every tensor) and each running statistic; the bars of
# tests/test_torch_port_bf16.py for the port's bf16 step against the JAX
# package's. The two round the same values to bf16 but sum in f32 in other
# orders, so an output one bf16 ulp apart moves what follows it.
BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_STAT_RTOL = 2e-3, 3e-1, 5e-3
# remat modes of the UNet (phase_remat), each against remat off
REMAT_MODES = ["full", "conv", "bn"]
# (B, Cin, H, W, Cout) of the Pallas probes' defaults: P1's x
# (benchmarks/bench_moments.py:28), P2-P5's conv
# (benchmarks/bench_pallas_conv.py:377-389)
PROBE_SHAPE = (32, 64, 320, 320, 64)
# P1's NHWC cases beyond PROBE_SHAPE: C 1, 3 and 96 over 100011 rows (which
# fill no block evenly), batch 1
MOMENT_ODD_SHAPES = [(3, 37, 901, 1), (3, 37, 901, 3), (3, 37, 901, 96), (1, 5, 7, 64)]
# P1's bars: each sum within 1e-5 of Σ|x| (Σx) or Σx² (Σx²) per channel; the
# mean within 1e-5, the variance within 1e-4·E[x²] (a mean of 3 makes
# Σx²/n − mean² cancel)
MOMENT_SUM_TOL, MOMENT_MEAN_ATOL, MOMENT_VAR_TOL = 1e-5, 1e-5, 1e-4
# (wrapper, (B, H, W, Cin, Cout)) of P2-P5's odd cases: Cin 128 for P2/P3,
# P4 at Cin 3 and 96 with H = 13, batch 1, 13x17 and 13x21 images (Cin 3,
# 5 and Cout 7 take the cp.async path in bf16 too); then ragged cases of
# the bf16 TMA path: H and W past whole tiles (13 and 70 against tiles of
# 4 or 8 rows x 64 pixels), Cin and Cout 8, 24 and 200 at batch 2, several
# N slices (Cout 200 and 40), every N width the plan picks (16, 32, 64, 96,
# 128), and images of one row or one column, smaller than a TMA box; last,
# cases of the f32 TMA path: Cin and Cout 4 and 12 (multiples of 4 that
# bf16 sends to the cp.async path), Cout 96 (three N slices of 32) over
# three row tiles of 4, Cout 6 (f32's cp.async path)
CONV_PROBE_ODD = [("conv3x3_single", (1, 13, 17, 128, 128)), ("conv3x3_db", (2, 13, 17, 128, 64)),
                  ("conv3x3_l1", (2, 13, 17, 3, 32)), ("conv3x3_l1", (1, 13, 16, 96, 96)),
                  ("conv3x3_l1", (1, 5, 9, 5, 7)), ("conv3x3_c64", (1, 13, 21, 64, 40)),
                  ("conv3x3_l1", (2, 13, 70, 8, 8)), ("conv3x3_l1", (2, 13, 70, 24, 24)),
                  ("conv3x3_l1", (2, 13, 70, 200, 200)), ("conv3x3_l1", (2, 11, 130, 8, 200)),
                  ("conv3x3_single", (2, 11, 70, 128, 200)), ("conv3x3_db", (2, 9, 70, 96, 24)),
                  ("conv3x3_c64", (2, 13, 70, 64, 8)), ("conv3x3_c64", (2, 13, 70, 64, 128)),
                  ("conv3x3_l1", (1, 1, 1, 8, 16)), ("conv3x3_single", (1, 1, 300, 128, 8)),
                  ("conv3x3_l1", (2, 300, 1, 16, 8)), ("conv3x3_l1", (2, 13, 70, 4, 12)),
                  ("conv3x3_l1", (1, 9, 33, 12, 4)), ("conv3x3_c64", (2, 9, 130, 64, 96)),
                  ("conv3x3_db", (1, 13, 17, 128, 6))]
# the shapes at which the probe CLIs (bench_conv3x3.main, bf16) run each
# wrapper: the main path's
CONV_PROBE_CLI = {"conv3x3_single": (32, 320, 320, 128, 128), "conv3x3_db": (32, 320, 320, 128, 128),
                  "conv3x3_l1": (32, 320, 320, 96, 96), "conv3x3_c64": (32, 320, 320, 64, 64)}
# f32 bar of P2-P5 (the probe's own, bench_pallas_conv.py:399)
CONV_PROBE_TOL = 2e-5


def conv_sites(conv_backend: str, double_convs: list = DOUBLE_CONVS) -> dict:
    """The 3x3 conv launches of one train step at batch 32, 320x320 of the
    UNet (or the trunk of ``double_convs``) →
    {kernel: [((B, Cin, H, W, Cout), prologue), ...]}, one entry per launch.

    Under ``pallas`` every conv is K3. Under ``pallas_fused`` conv0 is K4
    without the prologue and conv1 K4 with bn0 as its prologue; K5 is the
    backward of every K4 launch, K6 of every one but the stem's (its input
    needs no gradient). Under both, an Up's conv0 is two K3 calls, one per
    half of the concatenation."""
    b = CONFIG["batch_size"]
    sites: dict = {k: [] for k in CONV_KERNELS}
    fused = conv_backend == "pallas_fused"
    for cin, mid, cout, side, up in double_convs:
        def site(ci, co, prologue=False):
            return (b, ci, side, side, co), prologue
        if up:
            sites["conv3x3"] += [site(cin // 2, mid)] * 2
        else:
            sites["conv3x3_bn_act" if fused else "conv3x3"].append(site(cin, mid))
        if fused:
            sites["conv3x3_bn_act"].append(site(mid, cout, True))
        else:
            sites["conv3x3"].append(site(mid, cout))
    if fused:
        sites["wgrad3x3"] = list(sites["conv3x3_bn_act"])
        # the stems' inputs need no gradient: WNet has one per encoder
        sites["dgrad3x3"] = [c for c in sites["conv3x3_bn_act"] if c[0][1] != 1]
    return sites


def synthetic(num_examples: int, image_size: int, seed: int, num_inputs: int = 1):
    """The router's synthetic dataset, every item made before it is timed."""
    ds = router.build_dataset({"dataset": "synthetic", "num_examples": num_examples,
                               "image_size": image_size, "seed": seed,
                               "num_inputs": num_inputs})
    for i in range(len(ds)):
        ds[i]
    return ds


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take for work of ``flops`` f32
    operations at ``peak`` FLOP/s on ``nbytes`` bytes each moved once, and
    which of the two bounds it."""
    ops_ms = 1e3 * flops / peak
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def add_bound(result: dict, flops: float, nbytes: float, times: int = 1,
              peak: float = PEAK_FP32_FLOPS) -> None:
    """Add one shape's bound (``times`` launches of it) to a kernel's sums."""
    ms, by = bound(flops, nbytes, peak)
    result["bound_ms"] = result.get("bound_ms", 0.0) + times * ms
    shares = result.setdefault("_bound_shares", {})
    shares[by] = shares.get(by, 0.0) + times * ms


def close_bound(result: dict) -> dict:
    """bound_by: the bound that holds for most of the summed bound time."""
    shares = result.pop("_bound_shares")
    result["bound_by"] = max(shares, key=shares.get)
    return result


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def require_launches(phase: str, counts: dict, names) -> None:
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{phase}: kernels not on the path: {missing} ({counts})")


def phase_env() -> str:
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(
        "env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc, card=smi,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
    )
    return smi


def phase_build() -> None:
    info = _build.build()
    _build.library()
    usage = [ln.strip() for ln in info.log.splitlines() if "Used" in ln]
    emit("build", compiled=info.compiled, seconds=info.seconds, library=str(info.path),
         ptxas=usage)


def _dtype_sums() -> dict:
    """Per-dtype sums of the main-path shapes' times and bounds."""
    return {dtype: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
            for dtype in (torch.float32, torch.bfloat16)}


def _emit_bf16_sums(phase: str, sums: dict) -> None:
    """The bf16 sums of a kernel over its main-path shapes, one line."""
    emit(f"{phase}_bf16_sums", dtype="bfloat16", **close_bound(sums[torch.bfloat16]))


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a bf16 or f32 tensor, so that ±0 count as apart."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` at an odd element offset: the bf16 K1
    kernels take it one column a thread (``upsample.vector_width``)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def k1_plans() -> None:
    """The bf16 K1 kernels' plan as the library computes it
    (``im2im_upsample2x_plan``) against ``upsample.upsample_plan``, at every
    shape the K1 phases run, one column a thread and at each vector width
    that fits W."""
    lib = _build.library()
    cases = 0
    for _, _, h, w in DECODER_SHAPES + ODD_SHAPES:
        for vec in (1, upsample.FWD_VECTOR, upsample.BWD_VECTOR):
            if w % vec:
                continue
            out = (ctypes.c_int * 6)()
            _build.check(lib.im2im_upsample2x_plan(h, w, vec, out), "upsample2x_plan")
            p = upsample.upsample_plan(h, w, vec)
            want = [p.vec, p.units, p.col_tiles, p.rows, p.tiles, p.groups]
            if list(out) != want:
                raise AssertionError(f"K1 plan at {(h, w)} vec {vec}: the library's {list(out)}, "
                                     f"upsample_plan's {want}")
            cases += 1
    emit("k1_plan", cases=cases, same=True)


def _k1_one_column(phase: str, fn, t: torch.Tensor, want: torch.Tensor) -> None:
    """The bf16 kernel one column a thread (its input at an odd element
    offset): the same bits as the vector instance's ``want``, and its time."""
    tu = unaligned_copy(t)
    got = fn(tu)
    torch.cuda.synchronize()
    differ = int((bits(got) != bits(want)).sum())
    if differ:
        raise AssertionError(f"{phase}: one column a thread at {tuple(t.shape)}, {differ} "
                             f"outputs apart from the vector instance's")
    emit(f"{phase}_one_column", shape=list(t.shape), dtype="bfloat16", outputs_differ=differ,
         ms=time_ms(lambda: fn(tu), 20), vector_ms=time_ms(lambda: fn(t), 20))


def phase_k1() -> dict:
    """K1 vs plain: f32 within 1e-6·max|x|; bf16 bit for bit (0 outputs
    differ, ±0 apart): the plain version is the TPU kernel's bf16 function,
    with its per-operation rounding, and the kernel computes the same
    operations; the same bits twice. Timed at the decoder shapes; the sums
    run over K1_STEP_SHAPES (up1's line is timed on its own). → the f32
    sums (the kernels line's); the bf16 sums on a k1_bf16_sums line; the
    one-column instance at (32, 128, 80, 80) on a k1_one_column line."""
    k1_plans()
    g = torch.Generator(device="cuda").manual_seed(1)
    sums = _dtype_sums()
    for dtype in (torch.float32, torch.bfloat16):
        for shape in DECODER_SHAPES + ODD_SHAPES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            got = upsample.upsample2x(x)
            again = upsample.upsample2x(x)
            want = upsample.upsample2x_plain(x)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            differ = int((bits(got) != bits(want)).sum().item())
            twice = torch.equal(bits(got), bits(again))
            if dtype == torch.float32:
                tol = 1e-6 * x.abs().max().item()
                ok = diff.max().item() <= tol
            else:
                tol = 0.0
                ok = differ == 0
            if not ok or not twice:
                raise AssertionError(
                    f"K1 disagrees with its plain version at {shape} {dtype}: "
                    f"max abs err {diff.max().item()} > tol {tol}, {differ} outputs differ, "
                    f"the same bits twice: {twice}"
                )
            fields = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": diff.max().item(), "tol": tol, "outputs_differ": differ,
                      "same_bits_twice": twice}
            if shape in DECODER_SHAPES:
                fields["ms"] = time_ms(lambda: upsample.upsample2x(x), 20)
                fields["plain_ms"] = time_ms(lambda: upsample.upsample2x_plain(x), 5)
                fields["library_ms"] = time_ms(lambda: F.interpolate(
                    x, scale_factor=2, mode="bilinear", align_corners=True), 20)
                fields["launched_by_step"] = shape in K1_STEP_SHAPES
            if shape in K1_STEP_SHAPES:
                result = sums[dtype]
                result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                for k in ("ms", "plain_ms", "library_ms"):
                    result[k] += fields[k]
                # 3 lerps of 2 operations per output; x read, y written
                add_bound(result, 6 * 4 * x.numel(), x.element_size() * 5 * x.numel())
            if shape == K1_ONE_COLUMN_SHAPE and dtype == torch.bfloat16:
                _k1_one_column("k1", upsample.upsample2x, x, got)
            emit("k1", **fields)
    _emit_bf16_sums("k1", sums)
    k1_route(g)
    return close_bound(sums[torch.float32])


def k1_route(gen: torch.Generator) -> None:
    """The decoder's upsample at up1's input, which the TPU kernel does not
    take: output and input gradient equal to ``upsample2x_xla``'s bit for
    bit, in f32 and bf16, and no K1 launch."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(UP1_SHAPE, generator=gen, device="cuda").to(dtype)
        b, c, h, w = UP1_SHAPE
        g = torch.randn((b, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
        xs = [x.clone().requires_grad_() for _ in range(2)]
        before = (upsample.upsample2x.launches, upsample.upsample2x_bwd.launches)
        ys = [resize.upsample2x_align_corners(xs[0]), resize.upsample2x_xla(xs[1])]
        for y, xi in zip(ys, xs):
            y.backward(g)
        torch.cuda.synchronize()
        launched = (upsample.upsample2x.launches - before[0],
                    upsample.upsample2x_bwd.launches - before[1])
        differ = (int((ys[0] != ys[1]).sum()), int((xs[0].grad != xs[1].grad).sum()))
        emit("k1_route", shape=list(UP1_SHAPE), dtype=_dtype_name(dtype),
             outputs_differ=differ[0], gradients_differ=differ[1], k1_launches=list(launched))
        if differ != (0, 0) or launched != (0, 0):
            raise AssertionError(f"up1's upsample is not the XLA form at {UP1_SHAPE} {dtype}: "
                                 f"{differ} outputs and gradients differ, K1 launched {launched}")


def require_k1_per_step(phase: str, counts: dict, steps: int) -> None:
    """K1f and K1b launched K1_PER_STEP times in each of ``steps`` steps."""
    got = (counts["upsample2x"], counts["upsample2x_bwd"])
    if got != (K1_PER_STEP * steps,) * 2:
        raise AssertionError(f"{phase}: K1f/K1b launched {got} times in {steps} steps, "
                             f"not {K1_PER_STEP} each a step")


def _k2_maps(n: int, p: int, gen: torch.Generator, signed: bool) -> tuple:
    """(pred, label, dl, du) on the card: residuals of both signs, slopes in
    [0.05, 0.5] with rows of zero slopes; ``signed``: slopes of both signs,
    ±0, ±inf and NaN, and residuals inside the 1e-6 guard."""
    pred = torch.rand((n, p), generator=gen, device="cuda")
    label = pred + 0.3 * torch.randn((n, p), generator=gen, device="cuda")
    dl = 0.05 + 0.45 * torch.rand((n, p), generator=gen, device="cuda")
    du = 0.05 + 0.45 * torch.rand((n, p), generator=gen, device="cuda")
    dl[0, :1000] = 0.0  # zero slopes: missed at every finite λ where the guard passes
    du[min(1, n - 1), :1000] = 0.0
    if signed:
        for slope in (dl, du):
            pick = torch.randint(0, 10, (n, p), generator=gen, device="cuda")
            slope[pick < 4] *= -1.0
            for v, special in enumerate([0.0, -0.0, float("inf"), -float("inf"), float("nan")]):
                slope[pick == 4 + v] = special
        label[:, :7] = pred[:, :7] - 5e-7
    return pred, label, dl, du


def _k2_ties(n: int, p: int, lam: torch.Tensor, gen: torch.Generator) -> tuple:
    """Maps whose residual is exactly λ·s for a finite λ of the grid."""
    finite = lam[torch.isfinite(lam)]
    s = 0.5 + torch.randint(0, 8, (n, p), generator=gen, device="cuda").float() / 16
    r = (finite[torch.randint(0, finite.numel(), (n, p), generator=gen, device="cuda")] * s).abs()
    side = torch.rand((n, p), generator=gen, device="cuda") < 0.5
    return torch.where(side, r, -r), torch.zeros_like(r), s, s.clone()


def _k2_grids(lam: torch.Tensor, gen: torch.Generator) -> dict:
    """The calibration grid and the edge grids of the same length."""
    num = lam.numel()
    perm = torch.randperm(num, generator=gen, device="cuda")
    special = lam[perm].clone()
    special[:12] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0,
                                 float("nan"), 0.0, -0.0, float("inf"), -1.5, -0.25, 2.0],
                                device="cuda")
    return {
        "grid": lam,
        "unsorted": lam[perm],
        "duplicates": lam[torch.randint(0, num // 4, (num,), generator=gen, device="cuda")],
        "negative": torch.linspace(-6.0, 6.0, num, device="cuda")[perm],
        "zeros_nan_inf": special,
    }


def phase_k2(lam) -> dict:
    """K2 vs plain: the same table bit for bit (its counts are integers) and
    the same bits twice, at the main path's (32, 102400) and L = 1000 on the
    calibration grid and on edge grids (unsorted, duplicates, negative, ±0
    with NaN and ±inf), with slopes of both signs, ±0, ±inf and NaN and with
    exact ties λ·s == r; the same at an odd P, and at L = 20000, whose
    bins do not fit shared memory. Timed on the calibration grid."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, p = 32, IMAGE * IMAGE
    cases = []
    for shape in [(n, p), (5, 1001)]:
        grids = _k2_grids(lam, gen)
        for name, grid in grids.items():
            cases.append((shape, name, "default", _k2_maps(*shape, gen, False), grid))
            cases.append((shape, name, "signed", _k2_maps(*shape, gen, True), grid))
        cases.append((shape, "grid", "ties", _k2_ties(*shape, grids["grid"], gen), grids["grid"]))
        cases.append((shape, "negative", "ties", _k2_ties(*shape, grids["negative"], gen),
                      grids["negative"]))
    wide = torch.linspace(-3.0, 3.0, 20000, device="cuda")
    wide = wide[torch.randperm(wide.numel(), generator=gen, device="cuda")]
    cases.append(((3, 1001), "wide_20000", "signed", _k2_maps(3, 1001, gen, True), wide))
    for (cn, cp), grid_name, maps_name, maps, grid in cases:
        got = loss_table.loss_table(*maps, grid)
        again = loss_table.loss_table(*maps, grid)
        want = loss_table.loss_table_plain(*maps, grid)
        torch.cuda.synchronize()
        differ = int((got != want).sum().item())
        if differ or not torch.equal(got, again):
            raise AssertionError(f"K2 at {(cn, cp)}, grid {grid_name}, maps {maps_name}: "
                                 f"{differ} cells differ from the plain version, "
                                 f"the same bits twice: {torch.equal(got, again)}")
        emit("k2", shape=[cn, cp], num_lambdas=int(grid.numel()), grid=grid_name,
             maps=maps_name, cells_differ=differ, cells=got.numel(), bit_identical=True)
    pred, label, dl, du = cases[0][3]
    ms = time_ms(lambda: loss_table.loss_table(pred, label, dl, du, lam), 50)
    plain_ms = time_ms(lambda: loss_table.loss_table_plain(pred, label, dl, du, lam), 2)
    num_lam = int(lam.shape[0])
    # the four maps read once, the table written once; brute_force_ms: the
    # first design's two multiplies and two compares per (pixel, λ) at the
    # f32 peak. No single PyTorch call computes the table: library_ms is null.
    result = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "brute_force_ms": bound(4 * n * p * num_lam, 0)[0]}
    add_bound(result, 0, 4 * (4 * n * p + num_lam + n * num_lam))
    emit("k2", shape=[n, p], num_lambdas=num_lam, ms=ms, plain_ms=plain_ms,
         bound_ms=result["bound_ms"], brute_force_ms=result["brute_force_ms"])
    return close_bound(result)


def phase_k1b() -> dict:
    """K1b vs plain: f32 within 4e-6·max|g| (each dx sums up to 16 taps
    whose weights add up to about 4, so this is a few f32 ulps); bf16
    within one bf16 ulp of the plain result computed in f32 and rounded
    once, and bit for bit: the kernel keeps the plain version's order (the
    W axis first, every operation rounded); the same bits twice. Shapes are
    those of dx (the upsample's input); sums as phase_k1's."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    sums = _dtype_sums()
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, h, w in DECODER_SHAPES + ODD_SHAPES:
            g = torch.randn((b, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
            got = upsample.upsample2x_bwd(g)
            again = upsample.upsample2x_bwd(g)
            want = upsample.upsample2x_bwd_plain(g)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            differ = int((bits(got) != bits(want)).sum().item())
            twice = torch.equal(bits(got), bits(again))
            if dtype == torch.float32:
                tol = 4e-6 * g.abs().max().item()
                ok = diff.max().item() <= tol
            else:
                tol = conv_probe.bf16_ulp(want)
                ok = bool((diff <= tol).all()) and differ == 0
                tol = tol.max().item()
            if not ok or not twice:
                raise AssertionError(
                    f"K1b disagrees with its plain version at {tuple(g.shape)} {dtype}: "
                    f"max abs err {diff.max().item()} > tol {tol} or {differ} outputs differ, "
                    f"the same bits twice: {twice}"
                )
            fields = {"cotangent": list(g.shape), "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": diff.max().item(), "tol": tol, "outputs_differ": differ,
                      "same_bits_twice": twice}
            if (b, c, h, w) in DECODER_SHAPES:
                fields["ms"] = time_ms(lambda: upsample.upsample2x_bwd(g), 20)
                fields["plain_ms"] = time_ms(lambda: upsample.upsample2x_bwd_plain(g), 5)
                # the backward of F.interpolate, which autograd would call
                fields["library_ms"] = time_ms(
                    lambda: torch.ops.aten.upsample_bilinear2d_backward(
                        g, [2 * h, 2 * w], [b, c, h, w], True), 20)
                fields["launched_by_step"] = (b, c, h, w) in K1_STEP_SHAPES
            if (b, c, h, w) in K1_STEP_SHAPES:
                result = sums[dtype]
                result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                for k in ("ms", "plain_ms", "library_ms"):
                    result[k] += fields[k]
                # each cotangent element feeds 4 inputs: 4 multiply-adds
                add_bound(result, 8 * g.numel(), g.element_size() * (g.numel() + b * c * h * w))
            if (b, c, h, w) == K1_ONE_COLUMN_SHAPE and dtype == torch.bfloat16:
                _k1_one_column("k1b", upsample.upsample2x_bwd, g, got)
            emit("k1b", **fields)
    _emit_bf16_sums("k1b", sums)
    return close_bound(sums[torch.float32])


def torch_pool_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx of ``F.max_pool2d(x, 2)`` by torch's autograd; zeros where torch
    refuses to pool (H or W < 2), since then nothing is pooled."""
    if min(x.shape[-2:]) < 2:
        return torch.zeros_like(x)
    xr = x.detach().clone().requires_grad_()
    F.max_pool2d(xr, 2).backward(g)
    return xr.grad


def phase_k7() -> dict:
    """K7 vs its plain version and vs torch's autograd of F.max_pool2d:
    bit-identical (it moves values and does no arithmetic)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    sums = _dtype_sums()
    cases = [(s, "randn") for s in POOL_SHAPES + WNET_POOL_SHAPES + POOL_ODD_SHAPES]
    cases += [((2, 8, 6, 10), "constant"), ((2, 8, 6, 10), "zero_one")]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, kind in cases:
            if kind == "randn":
                x = torch.randn(shape, generator=gen, device="cuda")
            elif kind == "constant":  # every window is a four-way tie
                x = torch.ones(shape, device="cuda")
            else:  # ties between some of the elements of most windows
                x = torch.randint(0, 2, shape, generator=gen, device="cuda").float()
            x = x.to(dtype)
            b, c, h, w = shape
            g = torch.randn((b, c, h // 2, w // 2), generator=gen, device="cuda").to(dtype)
            got = pool.max_pool2x2_bwd(x, g)
            plain = pool.max_pool2x2_bwd_plain(x, g)
            ref = torch_pool_grad(x, g)
            torch.cuda.synchronize()
            if not (torch.equal(got, plain) and torch.equal(got, ref)):
                raise AssertionError(
                    f"K7 disagrees at {shape} {kind} {dtype}: plain {torch.equal(got, plain)}, "
                    f"autograd {torch.equal(got, ref)}"
                )
            fields = {"shape": list(shape), "input": kind, "dtype": str(dtype).split(".")[-1],
                      "max_abs_err": (got.float() - plain.float()).abs().max().item()
                      if got.numel() else 0.0}
            if shape in POOL_SHAPES:
                _, idx = F.max_pool2d(x, 2, return_indices=True)
                fields["ms"] = time_ms(lambda: pool.max_pool2x2_bwd(x, g), 20)
                fields["plain_ms"] = time_ms(lambda: pool.max_pool2x2_bwd_plain(x, g), 5)
                # torch's own max-pool backward (given its forward's indices)
                fields["library_ms"] = time_ms(
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        g, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx), 20)
                result = sums[dtype]
                result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                for k in ("ms", "plain_ms", "library_ms"):
                    result[k] += fields[k]
                # three compares per window; x and g read, dx written
                add_bound(result, 3 * g.numel(), x.element_size() * (2 * x.numel() + g.numel()))
            emit("k7", **fields)
    _emit_bf16_sums("k7", sums)
    return close_bound(sums[torch.float32])


def _conv_case(b: int, cin: int, h: int, w: int, cout: int, gen: torch.Generator) -> dict:
    """Inputs of one conv shape: weights at torch's init scale, scale > 0 and
    shift > 0 for the prologue (a prologue leaking into the zero frame
    shows), a random cotangent."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    return {"x": randn(b, cin, h, w), "w": randn(cout, cin, 3, 3) / (9 * cin) ** 0.5,
            "bias": 0.1 * randn(cout), "scale": 0.5 + rand(cin), "shift": 0.05 + 0.3 * rand(cin),
            "g": randn(b, cout, h, w)}


def _conv_calls(kernel: str, c: dict, prologue: bool):
    """(kernel call, plain call, library call, bars per output, bytes moved)
    of one conv kernel on the inputs ``c``. The library call computes the
    conv part alone: cuDNN has no fused prologue, stats or mask."""
    x, w, bias, sc, sh, g = (c[k] for k in ("x", "w", "bias", "scale", "shift", "g"))
    n = 4  # bytes per float
    if kernel == "conv3x3":
        return (lambda: (conv.conv3x3_fwd(x, w, bias),),
                lambda: (conv.conv3x3_plain(x, w, bias),),
                lambda: F.conv2d(x, w, bias, padding=1), [CONV_TOL],
                n * (x.numel() + w.numel() + bias.numel() + g.numel()))
    if kernel == "conv3x3_bn_act":
        return (lambda: conv.conv3x3_bn_act_fwd(x, w, bias, sc, sh, prologue, True),
                lambda: conv.conv3x3_bn_act_plain(x, w, bias, sc, sh, prologue, True),
                lambda: F.conv2d(x, w, bias, padding=1), [CONV_TOL, SUM_TOL],
                n * (x.numel() + w.numel() + bias.numel() + 2 * sc.numel() + g.numel()
                     + 2 * g.shape[0] * g.shape[1]))
    if kernel == "wgrad3x3":
        a = conv_bwd.prologue_activation(x, sc, sh, prologue)
        return (lambda: conv_bwd.wgrad3x3(x, g, sc, sh, prologue),
                lambda: conv_bwd.wgrad3x3_plain(x, g, sc, sh, prologue),
                lambda: torch.nn.grad.conv2d_weight(a, w.shape, g, padding=1),
                [SUM_TOL, SUM_TOL],
                n * (x.numel() + g.numel() + w.numel() + bias.numel() + 2 * sc.numel()))
    # x is read for the mask, and scale, shift and the two sums moved, only
    # with the prologue
    return (lambda: conv_bwd.dgrad3x3(g, x, w, sc, sh, prologue),
            lambda: conv_bwd.dgrad3x3_plain(g, x, w, sc, sh, prologue),
            lambda: torch.nn.grad.conv2d_input(x.shape, w, g, padding=1), [CONV_TOL, SUM_TOL],
            n * (g.numel() + w.numel() + (2 if prologue else 1) * x.numel()
                 + (4 * sc.numel() if prologue else 0)))


def _conv_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max |error|, relative L2 error, max |error| / max |want|)."""
    diff = (got.double() - want.double())
    ref = want.double()
    scale_l2, scale_max = ref.norm().item(), ref.abs().max().item()
    max_abs = diff.abs().max().item() if diff.numel() else 0.0
    rel_l2 = diff.norm().item() / scale_l2 if scale_l2 > 0 else diff.norm().item()
    rel_max = max_abs / scale_max if scale_max > 0 else max_abs
    return max_abs, rel_l2, rel_max


def conv_bound(shape: tuple, nbytes: float,
               peak: float = PEAK_F32_TC_FLOPS) -> tuple[float, str, float]:
    """(bound ms, what bounds it, a direct conv's operations) of one 3x3
    conv kernel at ``shape`` = (B, Cin, H, W, Cout).

    A direct conv does 9 multiply-adds per (output, channel pair). The
    bound counts 1, the limit of Winograd F(m×m, 3×3) ((m+2)² products per
    m² outputs) as m grows, which no algorithm in use for the conv or its
    gradients beats (F(4×4, 3×3) needs 2.25, an FFT more than 1), the
    transforms not counted, at the card's f32-accurate rate, 3xTF32 on the
    tensor cores (PEAK_F32_TC_FLOPS; ``peak``, PEAK_BF16_TC_FLOPS for bf16
    operands): Winograd's product stage is a batched GEMM, which runs there
    too."""
    b, cin, h, w, cout = shape
    direct = 2.0 * b * h * w * cin * cout * 9
    ms, by = bound(direct / 9, nbytes, peak)
    return ms, by, direct


# K5 and K6 in f32, each beside its TMA path: the name of its older kernel
# in the k5 / k6 lines, that kernel's call on a case, the odd shapes that
# must take the TMA path, and whether a case takes the TMA path
OLD_F32_PATHS = {
    "wgrad3x3": ("mma_sync", lambda c, p: conv_bwd.wgrad3x3_mma_sync(
        c["x"], c["g"], c["scale"], c["shift"], p), K5_TMA_ODD_SHAPES,
        lambda c: conv_bwd.wgrad_f32_uses_tma(c["x"], c["g"])),
    "dgrad3x3": ("cp_async", lambda c, p: conv_bwd.dgrad3x3_cp_async(
        c["g"], c["x"], c["w"], c["scale"], c["shift"], p), K6_TMA_ODD_SHAPES,
        lambda c: conv_bwd.dgrad_f32_uses_tma(c["g"], c["x"])),
}


def f32_path(kernel: str, shape: tuple, c: dict, tma_launches: int, want_tma: bool) -> str:
    """The path an f32 K5 or K6 case took ("tma", or its older kernel's
    name), from its ``OLD_F32_PATHS`` predicate (``conv_bwd.*_uses_tma``)
    and the two runs' launches on ``wgrad3x3.tma`` / ``dgrad3x3.tma``; raise
    where the two disagree, or where a case that must take the TMA path
    (``want_tma``) missed it."""
    phase = CONV_PHASES[kernel]
    old, _, _, uses_tma = OLD_F32_PATHS[kernel]
    path = "tma" if uses_tma(c) else old
    if tma_launches != (2 if path == "tma" else 0):
        raise AssertionError(f"{phase} {shape}: path {path} but {tma_launches} launches on "
                             f"{kernel}.tma in two runs")
    if want_tma and path != "tma":
        raise AssertionError(f"{phase} {shape}: a shape of the TMA path ran {path}")
    return path


def old_f32_path(kernel: str, fields: dict, c: dict, prologue: bool, run, want: tuple,
                 bars: list) -> None:
    """K5's mma.sync or K6's cp.async kernel at a main-path shape: within
    the same bars of the plain version ``want``, and timed in turns with the
    TMA path's ``run`` (TMA, old, old, TMA; the TMA time timed first is in
    ``fields["ms"]``) → ``<old>_ms``, its errors, and ms averaged over both
    turns."""
    name, call, _, _ = OLD_F32_PATHS[kernel]

    def old():
        return call(c, prologue)
    errs = [_conv_errors(a, b_) for a, b_ in zip(old(), want)]
    if any(max(e[1], e[2]) > bar for e, bar in zip(errs, bars)):
        raise AssertionError(f"{CONV_PHASES[kernel]} {fields['shape']}: the {name} path "
                             f"disagrees: {errs}")
    fields[f"{name}_max_abs_err"] = [e[0] for e in errs]
    fields[f"{name}_ms"] = (time_ms(old, 5) + time_ms(old, 5)) / 2
    fields["ms"] = (fields["ms"] + time_ms(run, 5)) / 2
    fields["card"] = torch.cuda.get_device_name(0)


def phase_conv_kernels() -> dict:
    """K3-K6 against their plain versions on the card, with TF32 off.

    Every conv launch of the batch-32 320x320 train step under
    ``pallas_fused`` and ``pallas`` (``conv_sites``), those of WNet's step
    under ``pallas_fused`` (untimed) and the odd shapes,
    prologue on and off where the kernel has one; each kernel run twice
    must give the same bits (no atomics); K4 without the stats (its eval
    form) must give the same y as with them. At the main-path shapes the
    kernel, plain and library times (CUDA events) and the bound, summed over
    each step's launches: the ``pallas_fused`` step's sums are the
    ``kernels`` line's; K3's sums over the ``pallas`` step are the
    ``k3_pallas_step`` line.
    """
    gen = torch.Generator(device="cuda").manual_seed(7)
    steps = {backend: conv_sites(backend) for backend in ("pallas_fused", "pallas")}
    results = {}
    per_shape: dict = {}  # (shape, prologue) -> {kernel phase: ms}
    for kernel in CONV_KERNELS:
        counts = {backend: collections.Counter(sites[kernel])
                  for backend, sites in steps.items() if sites[kernel]}
        main = list(dict.fromkeys(case for c in counts.values() for case in c))
        wnet = [c for c in dict.fromkeys(conv_sites("pallas_fused", WNET_DOUBLE_CONVS)[kernel])
                if c not in main]
        prologues = [False] if kernel == "conv3x3" else [True, False]
        old_name, _, odd_tma, _ = OLD_F32_PATHS.get(kernel, (None, None, [], None))
        odd = CONV_ODD_SHAPES + odd_tma
        cases = main + wnet + [(shape, p) for shape in odd for p in prologues]
        sums = {backend: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
                for backend in counts}
        tma_sums = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    f"{old_name}_ms": 0.0, "floor_ms": 0.0, "launches_per_step": 0}
        for (shape, prologue) in cases:
            b, cin, h, w, cout = shape
            c = _conv_case(b, cin, h, w, cout, gen)
            run, plain, library, bars, nbytes = _conv_calls(kernel, c, prologue)
            tma0 = KERNELS[f"{kernel}_tma"].launches if old_name else 0
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{kernel} {shape} prologue={prologue}: two runs differ")
            errs = [_conv_errors(a, b_) for a, b_ in zip(got, want)]
            fields = {"shape": list(shape), "prologue": prologue,
                      "max_abs_err": [e[0] for e in errs], "rel_l2_err": [e[1] for e in errs],
                      "rel_max_err": [e[2] for e in errs], "bars": bars, "bit_identical": True}
            if old_name:
                # every main-path shape but K5's stem must take the TMA path
                tma_launches = KERNELS[f"{kernel}_tma"].launches - tma0
                fields["path"] = f32_path(kernel, shape, c, tma_launches,
                                          ((shape, prologue) in main and cin > 1)
                                          or shape in odd_tma)
            if kernel == "conv3x3_bn_act":
                y_eval, _ = conv.conv3x3_bn_act_fwd(c["x"], c["w"], c["bias"], c["scale"],
                                                    c["shift"], prologue, False)
                if not torch.equal(y_eval, got[0]):
                    raise AssertionError(f"K4 {shape}: y without the stats differs")
            bad = [i for i, (e, bar) in enumerate(zip(errs, bars)) if max(e[1], e[2]) > bar]
            if bad:
                raise AssertionError(f"{kernel} {shape} prologue={prologue} disagrees with its "
                                     f"plain version in outputs {bad}: {fields}")
            if (shape, prologue) in main:
                fields["launches_per_step"] = {k: n[(shape, prologue)] for k, n in counts.items()
                                               if n[(shape, prologue)]}
                fields["ms"] = time_ms(run, 5)
                if old_name and fields["path"] == "tma":
                    old_f32_path(kernel, fields, c, prologue, run, want, bars)
                fields["plain_ms"] = time_ms(plain, 2)
                fields["library_ms"] = time_ms(library, 5)
                fields["bound_ms"], fields["bound_by"], direct = conv_bound(shape, nbytes)
                fields["direct_flop_ms"] = 1e3 * direct / PEAK_F32_TC_FLOPS
                fields["direct_tflops"] = direct / fields["ms"] / 1e9
                per_shape.setdefault((shape, prologue), {})[CONV_PHASES[kernel]] = fields["ms"]
                for backend, n in fields["launches_per_step"].items():
                    result = sums[backend]
                    result["max_abs_err"] = max(result["max_abs_err"], *fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms"):
                        result[k] += n * fields[k]
                    add_bound(result, direct / 9, nbytes, n, PEAK_F32_TC_FLOPS)
                n = fields["launches_per_step"].get("pallas_fused", 0)
                if old_name and fields["path"] == "tma" and n:
                    tma_sums["max_abs_err"] = max(tma_sums["max_abs_err"], *fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms", f"{old_name}_ms"):
                        tma_sums[k] += n * fields[k]
                    tma_sums["floor_ms"] += n * fields["direct_flop_ms"]
                    tma_sums["launches_per_step"] += n
                    add_bound(tma_sums, direct / 9, nbytes, n, PEAK_F32_TC_FLOPS)
            emit(CONV_PHASES[kernel], **fields)
            del c, got, again, want
        results[kernel] = close_bound(sums["pallas_fused"])
        if old_name:
            close_bound(tma_sums)
            emit(f"{CONV_PHASES[kernel]}_step", card=torch.cuda.get_device_name(0), **tma_sums,
                 **{f"speedup_over_{old_name}": tma_sums[f"{old_name}_ms"] / tma_sums["ms"]},
                 over_library=tma_sums["ms"] / tma_sums["library_ms"])
            results[f"{kernel}_tma"] = {k: tma_sums[k] for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if "pallas" in sums:
            emit("k3_pallas_step", launches_per_step=sum(counts["pallas"].values()),
                 **close_bound(sums["pallas"]))
    for (shape, prologue), times in per_shape.items():
        emit("conv_shape", shape=list(shape), prologue=prologue, stem=shape[1] == 1,
             **{f"{k}_ms": times.get(k) for k in CONV_PHASES.values()})
    return results


def bf16_bar(a: torch.Tensor, w: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The per-output bar of a bf16 conv against its plain version ``want``
    (``conv_probe.bf16_tolerance`` in NCHW): one bf16 ulp of ``want`` plus
    the worst-case difference of two f32 sums of the 9·Cin products of the
    activation ``a`` and the kernel ``w`` in different orders."""
    mass = conv.conv3x3_plain(a.float().abs(), w.float().abs())
    return conv_probe.bf16_ulp(want) + 2.0 * 9 * a.shape[1] * 2.0**-24 * mass


def k34_bf16_over(got: tuple, want: tuple, act: torch.Tensor, w: torch.Tensor) -> tuple:
    """(outputs of y over ``bf16_bar``, stats over their bar or None) of a
    bf16 K3/K4 call ``got`` against its plain version ``want`` on the
    activation ``act`` and kernel ``w``: the stats within what y's bar lets
    Σy and Σy² move plus SUM_TOL of Σ|y| and Σy² (the f32 sums' order)."""
    bar = bf16_bar(act, w, want[0])
    y_over = int(((got[0].float() - want[0].float()).abs() > bar).sum().item())
    if len(want) < 2:
        return y_over, None
    yf = want[0].float()
    st_bar = torch.stack([bar.sum((2, 3)) + SUM_TOL * yf.abs().sum((2, 3)),
                          (bar * (2 * yf.abs() + bar)).sum((2, 3))
                          + SUM_TOL * (yf * yf).sum((2, 3))], 1)
    return y_over, int(((got[1] - want[1]).abs() > st_bar).sum().item())


def bf16_conv_sites() -> dict:
    """The bf16 K3-K6 launches of the bf16 main paths at batch 32, 320x320
    → {kernel: {path: Counter of ((B, Cin, H, W, Cout), prologue)}}: K3 in
    the forward of the ``pallas`` train step (every conv) and in the
    ``pallas_fused`` eval forward (an Up's conv0 halves); K4 in the
    ``pallas_fused`` eval forward (conv0 without the prologue, conv1 with
    it, no stats); K5 and K6 in the backward of the ``pallas_fused`` train
    step (the backward of every K4; K6 not for the stem's)."""
    fused = conv_sites("pallas_fused")
    return {
        "conv3x3_bf16": {"pallas": collections.Counter(conv_sites("pallas")["conv3x3"]),
                         "pallas_fused": collections.Counter(fused["conv3x3"])},
        "conv3x3_bn_act_bf16": {"pallas_fused": collections.Counter(fused["conv3x3_bn_act"])},
        "wgrad3x3_bf16": {"pallas_fused": collections.Counter(fused["wgrad3x3"])},
        "dgrad3x3_bf16": {"pallas_fused": collections.Counter(fused["dgrad3x3"])},
    }


def phase_conv_kernels_bf16() -> dict:
    """The bf16 instances of K3 and K4 against their plain versions on the
    card, at every conv launch of the bf16 paths (``bf16_conv_sites``) and
    the odd shapes, prologue on and off for K4: y within ``bf16_bar``; K4's
    stats within what that bar lets Σy and Σy² move plus SUM_TOL of Σ|y| and
    Σy² (the f32 sums' order); each run twice, the same bits; K4 without the
    stats the same y as with them. At the main-path shapes the kernel (K4
    without the stats, as serving runs it), plain and library (``F.conv2d``
    in bf16) times and the bound (bf16 tensor-core rate, 2-byte tensors),
    summed per ``pallas`` train step for K3 and per ``pallas_fused`` eval
    forward for K4 (the kernels line's); K3's sums over the fused eval
    forward on a ``k3_bf16_fused_eval`` line. Each call must launch the
    kernel once and, beyond the stem (Cin = 1), the activation pass once.
    The per-level table (K3/K4 against cuDNN bf16, ms per launch) on a
    ``k34_bf16_levels`` line."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    results = {}
    sites = bf16_conv_sites()
    levels: dict = {}  # (shape, prologue) -> {"k3_ms" / "k4_ms", "library_ms"}
    for kernel in ("conv3x3_bf16", "conv3x3_bn_act_bf16"):
        paths = sites[kernel]
        main = list(dict.fromkeys(case for c in paths.values() for case in c))
        prologues = [False] if kernel == "conv3x3_bf16" else [True, False]
        cases = main + [(shape, p) for shape in CONV_ODD_SHAPES for p in prologues]
        sums = {path: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
                for path in paths}
        for shape, prologue in cases:
            b, cin, h, w, cout = shape
            c = _conv_case(b, cin, h, w, cout, gen)
            x, wt, bias = (c[k].to(torch.bfloat16) for k in ("x", "w", "bias"))
            sc, sh = c["scale"], c["shift"]
            if kernel == "conv3x3_bf16":
                run = lambda: (conv.conv3x3_fwd(x, wt, bias),)  # noqa: E731
                plain = lambda: (conv.conv3x3_plain(x, wt, bias),)  # noqa: E731
                timed = run
            else:
                run = lambda: conv.conv3x3_bn_act_fwd(x, wt, bias, sc, sh, prologue, True)  # noqa: E731
                plain = lambda: conv.conv3x3_bn_act_plain(x, wt, bias, sc, sh, prologue, True)  # noqa: E731
                timed = lambda: conv.conv3x3_bn_act_fwd(x, wt, bias, sc, sh, prologue, False)  # noqa: E731
            before = (KERNELS[kernel].launches, conv_bwd.activation_nhwc.launches)
            got = run()
            launched = (KERNELS[kernel].launches - before[0],
                        conv_bwd.activation_nhwc.launches - before[1])
            if launched != (1, int(cin > 1)):
                raise AssertionError(f"{kernel} {shape}: launched (kernel, activation pass) "
                                     f"{launched} times, not (1, {int(cin > 1)})")
            again, want = run(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{kernel} {shape} prologue={prologue}: two runs differ")
            act = conv_bwd.prologue_activation(x.float(), sc, sh, prologue).to(torch.bfloat16)
            over, st_over = k34_bf16_over(got, want, act, wt)
            diff = (got[0].float() - want[0].float()).abs()
            fields = {"shape": list(shape), "prologue": prologue, "dtype": "bfloat16",
                      "max_abs_err": diff.max().item(), "outputs_over_bar": over,
                      "outputs_over_one_ulp": int((diff > conv_probe.bf16_ulp(want[0])).sum()),
                      "bit_identical": True,
                      "launched": {"kernel": launched[0], "activation_nhwc": launched[1]}}
            if kernel == "conv3x3_bn_act_bf16":
                fields["stats_over_bar"] = st_over
                y_eval, _ = timed()
                if not torch.equal(y_eval, got[0]):
                    raise AssertionError(f"K4 bf16 {shape}: y without the stats differs")
                over += st_over
            if over:
                raise AssertionError(f"{kernel} {shape} prologue={prologue} disagrees with its "
                                     f"plain version: {fields}")
            if (shape, prologue) in main:
                fields["launches"] = {p: n[(shape, prologue)] for p, n in paths.items()
                                      if n[(shape, prologue)]}
                fields["ms"] = time_ms(timed, 5)
                fields["plain_ms"] = time_ms(plain, 2)
                fields["library_ms"] = time_ms(lambda: F.conv2d(x, wt, bias, padding=1), 5)
                fields["vs_library"] = fields["ms"] / fields["library_ms"]
                level = levels.setdefault((shape, prologue), {})
                level["k3_ms" if kernel == "conv3x3_bf16" else "k4_ms"] = fields["ms"]
                level.setdefault("library_ms", fields["library_ms"])
                nbytes = 2 * (x.numel() + wt.numel() + bias.numel() + b * cout * h * w)
                if prologue:
                    nbytes += 8 * cin
                fields["bound_ms"], fields["bound_by"], _ = conv_bound(shape, nbytes,
                                                                       PEAK_BF16_TC_FLOPS)
                for path, n in fields["launches"].items():
                    result = sums[path]
                    result["max_abs_err"] = max(result["max_abs_err"], fields["max_abs_err"])
                    for k in ("ms", "plain_ms", "library_ms"):
                        result[k] += n * fields[k]
                    add_bound(result, 2.0 * b * h * w * cin * cout, nbytes, n, PEAK_BF16_TC_FLOPS)
            emit(kernel, **fields)
            del c, x, got, again, want, act, diff
        if kernel == "conv3x3_bf16":
            emit("k3_bf16_fused_eval", launches_per_forward=sum(paths["pallas_fused"].values()),
                 **close_bound(sums["pallas_fused"]))
            results[kernel] = close_bound(sums["pallas"])
        else:
            results[kernel] = close_bound(sums["pallas_fused"])
    emit("k34_bf16_levels", rows=[
        {"shape": list(shape), "prologue": prologue, "k3_ms": t.get("k3_ms"),
         "k4_ms": t.get("k4_ms"), "library_ms": t["library_ms"],
         "vs_library": max(t.get("k3_ms") or 0.0, t.get("k4_ms") or 0.0) / t["library_ms"]}
        for (shape, prologue), t in levels.items()])
    return results


def activation_sites() -> dict:
    """The activation pass's launches in each bf16 main path at batch 32,
    320x320 → {path: Counter of ((B, C, H, W), prologue)}: one for each K3
    or K4 call beyond the stem (``bf16_conv_sites``; K4's prologue applied)
    in the ``pallas`` train step's forward (``pallas``) and the
    ``pallas_fused`` eval forward (``pallas_fused_eval``); the
    ``pallas_fused`` train step (``pallas_fused``) adds one for each K5
    beyond the stem, which writes its K4's activation again."""
    sites = bf16_conv_sites()

    def passes(*counters) -> collections.Counter:
        out: collections.Counter = collections.Counter()
        for counter in counters:
            for ((b, cin, h, w, _), prologue), n in counter.items():
                if cin > 1:  # the stem reads x itself
                    out[(b, cin, h, w), prologue] += n
        return out

    k3, k4 = sites["conv3x3_bf16"], sites["conv3x3_bn_act_bf16"]["pallas_fused"]
    return {"pallas": passes(k3["pallas"]),
            "pallas_fused_eval": passes(k3["pallas_fused"], k4),
            "pallas_fused": passes(k3["pallas_fused"], k4,
                                   sites["wgrad3x3_bf16"]["pallas_fused"])}


def phase_activation_bf16() -> dict:
    """The activation pass (``conv_bwd.activation_nhwc``, K3/K4's and K5's
    NHWC operand) against its plain version on the card, bit for bit and
    the same bits twice, with the prologue and without, at every shape of
    ``activation_sites`` and the odd shapes. At each main-path site the
    kernel, plain and bound times (x read, scale and shift with the
    prologue, the NHWC copy written once; the prologue's multiply, add and
    max at the f32 rate) and, without the prologue, the library's:
    ``x.contiguous(memory_format=torch.channels_last)``, which writes the
    same bytes where C % 8 == 0 (every main-path site); with the prologue no
    single PyTorch call computes it. Summed over each path of
    ``activation_sites`` on an ``activation_bf16_path`` line, with the
    prologue's and the plain copy's launches apart; the ``pallas`` step's
    sums (its K3 sites, no prologue) are the kernels line's."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    paths = activation_sites()
    main = list(dict.fromkeys(site for c in paths.values() for site in c))
    cases = main + [((b, cin, h, w), p) for b, cin, h, w, _ in CONV_ODD_SHAPES if cin > 1
                    for p in (True, False)]
    per_site: dict = {}
    for shape, prologue in cases:
        b, cin, h, w = shape
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        sc = 0.5 + torch.rand((cin,), generator=gen, device="cuda")
        sh = 0.3 * torch.randn((cin,), generator=gen, device="cuda")
        args = (x, sc, sh, prologue)
        got, again = conv_bwd.activation_nhwc(*args), conv_bwd.activation_nhwc(*args)
        want = conv_bwd.activation_plain(*args)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        fields = {"shape": list(shape), "prologue": prologue, "dtype": "bfloat16",
                  "outputs_differ": differ, "bit_identical": bool(torch.equal(got, again)),
                  "max_abs_err": (got.float() - want.float()).abs().max().item()}
        if differ or not fields["bit_identical"]:
            raise AssertionError(f"activation pass {shape} prologue={prologue} differs from "
                                 f"its plain version: {fields}")
        if (shape, prologue) in main:
            fields["launches"] = {path: n[shape, prologue] for path, n in paths.items()
                                  if n[shape, prologue]}
            fields["ms"] = time_ms(lambda: conv_bwd.activation_nhwc(*args), 10)
            fields["plain_ms"] = time_ms(lambda: conv_bwd.activation_plain(*args), 2)
            fields["library_ms"] = None
            if not prologue:
                library = x.contiguous(memory_format=torch.channels_last)
                if not torch.equal(library.permute(0, 2, 3, 1), got[..., :cin]):
                    raise AssertionError(f"activation pass {shape}: the channels_last copy "
                                         f"differs")
                fields["library_ms"] = time_ms(
                    lambda: x.contiguous(memory_format=torch.channels_last), 10)
                del library
            nbytes = 2 * (x.numel() + got.numel()) + (8 * cin if prologue else 0)
            flops = 3.0 * x.numel() if prologue else 0.0
            fields["bound_ms"], fields["bound_by"] = bound(flops, nbytes)
            per_site[shape, prologue] = dict(fields, flops=flops, nbytes=nbytes)
        emit("activation_bf16", **fields)
        del got, again, want
    results = {}
    for path, counts in paths.items():
        part = {k: {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
                for k in ("prologue", "no_prologue")}
        part["no_prologue"]["library_ms"] = 0.0
        sums = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        for (shape, prologue), n in counts.items():
            site = per_site[shape, prologue]
            split = part["prologue" if prologue else "no_prologue"]
            split["launches"] += n
            for k in ("ms", "plain_ms", "bound_ms") + (() if prologue else ("library_ms",)):
                split[k] += n * site[k]
            for k in ("ms", "plain_ms"):
                sums[k] += n * site[k]
            sums["max_abs_err"] = max(sums["max_abs_err"], site["max_abs_err"])
            add_bound(sums, site["flops"], site["nbytes"], n)
        sums["library_ms"] = (part["no_prologue"]["library_ms"]
                              if not part["prologue"]["launches"] else None)
        results[path] = close_bound(sums)
        emit("activation_bf16_path", path=path, launches=sum(counts.values()), **sums, **part)
    return {"activation_nhwc": results["pallas"]}


def _bwd_bf16_calls(kernel: str, c: dict, prologue: bool):
    """(kernel call, plain call, library call, bytes moved, the activation
    or cotangent mass) of K5 or K6 in bf16 on the inputs ``c`` (x, g and
    the weight rounded to bf16, scale and shift f32). The kernels read g
    through the cotangent pass's NHWC copy, as in the fused backward; the
    plain versions read g. The library call computes the conv part alone,
    on bf16 tensors."""
    x, g, w = (c[k].to(torch.bfloat16) for k in ("x", "g", "w"))
    sc, sh = c["scale"], c["shift"]
    cin, cout = x.shape[1], g.shape[1]
    gp = conv_bwd.cotangent_nhwc(g, None, None)
    if kernel == "wgrad3x3_bf16":
        a = conv_bwd.prologue_activation(x.float(), sc, sh, prologue).to(torch.bfloat16)
        return (lambda: conv_bwd.wgrad3x3_nhwc(x, gp, cout, sc, sh, prologue),
                lambda: conv_bwd.wgrad3x3_plain(x, g, sc, sh, prologue),
                lambda: torch.nn.grad.conv2d_weight(a, w.shape, g, padding=1),
                2 * (x.numel() + g.numel()) + 4 * (w.numel() + g.shape[1] + 2 * cin), None)
    # the mass of each dx: Σ|g||w| over its 9·Cout products
    mass = conv_bwd.dgrad3x3_plain(g.float().abs(), x.float(), w.float().abs(), None, None,
                                   False)[0]
    return (lambda: conv_bwd.dgrad3x3_nhwc(gp, x, w, sc, sh, prologue),
            lambda: conv_bwd.dgrad3x3_plain(g, x, w, sc, sh, prologue),
            lambda: torch.nn.grad.conv2d_input(x.shape, w, g, padding=1),
            2 * (g.numel() + w.numel() + 2 * x.numel()) + 4 * 4 * cin, mass)


def cotangent_cases() -> tuple[collections.Counter, list]:
    """The cotangent pass's (B, Cout, H, W) at each K4 launch of the bf16
    ``pallas_fused`` train step (every K4 there computes the stats), and
    the odd shapes'."""
    main = collections.Counter((b, cout, h, w) for (b, _, h, w, cout), _ in
                               conv_sites("pallas_fused")["conv3x3_bn_act"])
    return main, [(b, cout, h, w) for b, _, h, w, cout in CONV_ODD_SHAPES]


def phase_cotangent_bf16() -> dict:
    """The cotangent pass against its plain version on the card, bit for bit
    and the same bits twice, with the stats' terms and without, at every
    K4 launch of the bf16 ``pallas_fused`` train step and the odd shapes.
    At the main-path shapes (with the stats) kernel, plain and bound times
    (gy, y and the NHWC g moved once), summed over the step: the kernels
    line's. No single PyTorch call computes it."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    counts, odd = cotangent_cases()
    sums = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
    for shape in list(counts) + odd:
        b, ch = shape[:2]
        gy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        gst = 1e-2 * torch.randn((b, 2, ch), generator=gen, device="cuda")
        for stats in (True, False):
            args = (gy, y, gst) if stats else (gy, None, None)
            got, again = conv_bwd.cotangent_nhwc(*args), conv_bwd.cotangent_nhwc(*args)
            want = conv_bwd.cotangent_plain(*args)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            fields = {"shape": list(shape), "stats": stats, "dtype": "bfloat16",
                      "outputs_differ": differ, "bit_identical": bool(torch.equal(got, again)),
                      "max_abs_err": (got.float() - want.float()).abs().max().item()}
            if differ or not fields["bit_identical"]:
                raise AssertionError(f"cotangent pass {shape} stats={stats} differs from its "
                                     f"plain version: {fields}")
            if stats and shape in counts:
                n = counts[shape]
                fields["launches_per_step"] = n
                fields["ms"] = time_ms(lambda: conv_bwd.cotangent_nhwc(*args), 10)
                fields["plain_ms"] = time_ms(lambda: conv_bwd.cotangent_plain(*args), 2)
                nbytes = 2 * (gy.numel() + y.numel() + got.numel()) + 4 * gst.numel()
                fields["bound_ms"], fields["bound_by"] = bound(6.0 * gy.numel(), nbytes)
                sums["max_abs_err"] = max(sums["max_abs_err"], fields["max_abs_err"])
                for k in ("ms", "plain_ms"):
                    sums[k] += n * fields[k]
                add_bound(sums, 6.0 * gy.numel(), nbytes, n)
            emit("cotangent_bf16", **fields)
            del got, again, want
    return close_bound(sums)


def phase_conv_bwd_bf16() -> dict:
    """The bf16 instances of K5 and K6 against their plain versions on the
    card, at every K5/K6 launch of the bf16 ``pallas_fused`` train step
    (``bf16_conv_sites``) and the odd shapes, prologue on and off; each run
    twice, the same bits.

    Bars: both sides sum exact bf16 products in f32, in other orders. dW,
    db and K6's reductions are f32 sums over B·H·W terms, held as the f32
    kernels' are: relative L2 and max|error| / max|plain| ≤ SUM_TOL. dx is
    rounded once to bf16: within one bf16 ulp of the plain value plus what
    the f32 order can move, 2·K·2^-24·Σ|g||w| (K = 9·Cout) times the
    scale. Kernel and plain version round x·scale + shift alike (no FMA on
    either side), so no mask or activation flips at ties: none is allowed.
    At the main-path shapes the kernel, plain and library
    (``torch.nn.grad.conv2d_weight`` / ``conv2d_input`` on bf16 tensors)
    times and the bound (the bf16 tensor-core rate, 2-byte x and g), summed
    over the step's launches: the kernels line's. The kernels read g
    through the cotangent pass's NHWC copy (K5's time includes writing its
    activation NHWC, K6's packing its weights); the pass itself, which the
    step runs once for both, is timed on its own (phase_cotangent_bf16).
    At the odd shapes the public wrappers (``wgrad3x3``, ``dgrad3x3``),
    which run the pass on their g, must give the same bits."""
    results = {"cotangent_nhwc": phase_cotangent_bf16()}
    gen = torch.Generator(device="cuda").manual_seed(9)
    for kernel, paths in bf16_conv_sites().items():
        if kernel not in ("wgrad3x3_bf16", "dgrad3x3_bf16"):
            continue
        counts = paths["pallas_fused"]
        main = list(counts)
        cases = main + [(shape, p) for shape in CONV_ODD_SHAPES for p in (True, False)]
        sums = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        phase = "k5_bf16" if kernel == "wgrad3x3_bf16" else "k6_bf16"
        for shape, prologue in cases:
            b, cin, h, w, cout = shape
            c = _conv_case(b, cin, h, w, cout, gen)
            run, plain, library, nbytes, mass = _bwd_bf16_calls(kernel, c, prologue)
            got, again, want = run(), run(), plain()
            if (shape, prologue) not in main:  # the public wrappers take the same path
                x, g, w = (c[k].to(torch.bfloat16) for k in ("x", "g", "w"))
                public = (conv_bwd.wgrad3x3(x, g, c["scale"], c["shift"], prologue)
                          if phase == "k5_bf16" else
                          conv_bwd.dgrad3x3(g, x, w, c["scale"], c["shift"], prologue))
                if not all(torch.equal(a, b_) for a, b_ in zip(public, got)):
                    raise AssertionError(f"{kernel} {shape}: the public wrapper differs")
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{kernel} {shape} prologue={prologue}: two runs differ")
            if got[0].dtype != (torch.float32 if phase == "k5_bf16" else torch.bfloat16):
                raise AssertionError(f"{kernel}: output dtype {got[0].dtype}")
            sums_at = [0, 1] if phase == "k5_bf16" else ([1] if prologue else [])
            errs = [_conv_errors(got[i], want[i]) for i in sums_at]
            fields = {"shape": list(shape), "prologue": prologue, "dtype": "bfloat16",
                      "max_abs_err": max([e[0] for e in errs], default=0.0),
                      "sum_rel_l2_err": [e[1] for e in errs],
                      "sum_rel_max_err": [e[2] for e in errs], "sum_bar": SUM_TOL,
                      "bit_identical": True}
            over = sum(max(e[1], e[2]) > SUM_TOL for e in errs)
            if phase == "k6_bf16":
                scale = c["scale"][:, None, None] if prologue else 1.0
                bar = conv_probe.bf16_ulp(want[0]) + 2.0 * 9 * cout * 2.0**-24 * mass * scale
                diff = (got[0].float() - want[0].float()).abs()
                fields["max_abs_err"] = max(fields["max_abs_err"], diff.max().item())
                fields["dx_over_bar"] = int((diff > bar).sum().item())
                fields["dx_over_one_ulp"] = int((diff > conv_probe.bf16_ulp(want[0])).sum())
                over += fields["dx_over_bar"]
                if not prologue and got[1].any():
                    over += 1
                del bar, diff
            if over:
                raise AssertionError(f"{kernel} {shape} prologue={prologue} disagrees with its "
                                     f"plain version: {fields}")
            if (shape, prologue) in main:
                n = counts[(shape, prologue)]
                fields["launches_per_step"] = n
                fields["ms"] = time_ms(run, 5)
                fields["plain_ms"] = time_ms(plain, 2)
                fields["library_ms"] = time_ms(library, 5)
                fields["bound_ms"], fields["bound_by"], _ = conv_bound(shape, nbytes,
                                                                       PEAK_BF16_TC_FLOPS)
                sums["max_abs_err"] = max(sums["max_abs_err"], fields["max_abs_err"])
                for k in ("ms", "plain_ms", "library_ms"):
                    sums[k] += n * fields[k]
                add_bound(sums, 2.0 * b * h * w * cin * cout, nbytes, n, PEAK_BF16_TC_FLOPS)
            emit(phase, **fields)
            del c, got, again, want, mass
        results[kernel] = close_bound(sums)
    return results


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _moments_case(shape: tuple, dtype: torch.dtype, gen: torch.Generator, timed: bool) -> dict:
    """P1 against its plain version at one NHWC shape (x = N(3, 1)): the
    (2, C) sums, the mean and the variance each within their bars, the
    kernel's sums the same bits twice; with ``timed`` the kernel's, plain
    version's and library call's times and the bound."""
    x = (torch.randn(shape, generator=gen, device="cuda") + 3.0).to(dtype)
    n = x.numel() // shape[-1]
    got, again = moments.moment_sums(x), moments.moment_sums(x)
    want = moments.moment_sums_plain(x)
    x32 = x.float().reshape(n, -1)
    scale = torch.stack([x32.abs().sum(0), (x32 * x32).sum(0)])
    (m, v), (pm, pv) = moments.finish(got, n), moments.finish(want, n)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"moments {shape} {dtype}: two runs differ")
    sum_err = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
    mean_err = (m - pm).abs().max().item()
    ex2 = (scale[1] / n).max().item()
    var_err = (v - pv).abs().max().item()
    fields = {"kernel": "moments", "shape": list(shape), "dtype": _dtype_name(dtype),
              "max_abs_err": (got - want).abs().max().item(), "sum_rel_err": sum_err,
              "mean_abs_err": mean_err, "var_abs_err": var_err, "bit_identical": True,
              "bars": [MOMENT_SUM_TOL, MOMENT_MEAN_ATOL, MOMENT_VAR_TOL * ex2]}
    if sum_err > MOMENT_SUM_TOL or mean_err > MOMENT_MEAN_ATOL or var_err > MOMENT_VAR_TOL * ex2:
        raise AssertionError(f"P1 disagrees with its plain version: {fields}")
    if timed:
        fields["ms"] = time_ms(lambda: moments.moments(x), 20)
        fields["plain_ms"] = time_ms(lambda: moments.moments_plain(x), 5)
        fields["library_ms"] = time_ms(lambda: bench_moments.library_moments(x), 20)
        # an add, a multiply and an add per element; x read, 2C sums written
        fields["bound_ms"], fields["bound_by"] = bound(
            3 * x.numel(), x.numel() * x.element_size() + 8 * shape[-1])
    emit("probes", **fields)
    return fields


def _conv_probe_case(name: str, shape: tuple, dtype: torch.dtype, gen: torch.Generator,
                     timed: bool) -> dict:
    """One of P2-P5 against ``conv3x3_nobias_plain`` at (B, H, W, Cin,
    Cout): f32 within CONV_PROBE_TOL relative and absolute; bf16 within
    ``conv_probe.bf16_tolerance``: one bf16 ulp of the plain value plus the
    f32 sums' worst-case difference between two orders, 2·K·2^-24·Σ|x||w|
    (K = 9·Cin), which only matters where the sum cancels to near zero; the
    same bits twice. Timed: the wrapper, the plain version and ``F.conv2d``;
    in f32 also the ``cp.async`` path (``conv_probe.cp_async``, checked the
    same way), in turns with the wrapper (wrapper, cp.async, cp.async,
    wrapper) → ``cp_async_ms``, and the direct conv's 3xTF32 floor."""
    b, h, w, cin, cout = shape
    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / (9 * cin) ** 0.5).to(dtype)
    fn = KERNELS[name]
    got, again = fn(x, k), fn(x, k)
    want = conv_probe.conv3x3_nobias_plain(x, k)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {shape} {dtype}: two runs differ")
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        tol = CONV_PROBE_TOL * (1.0 + want.abs())
    else:
        tol = conv_probe.bf16_tolerance(x, k, want)
    worst = (diff / tol).max().item()
    fields = {"kernel": name, "shape": list(shape), "dtype": _dtype_name(dtype),
              "path": "tma" if conv_probe.uses_tma(x, k) else "cp_async",
              "max_abs_err": diff.max().item(), "err_over_bar": worst, "bit_identical": True}
    if worst > 1.0:
        raise AssertionError(f"{name} disagrees with its plain version: {fields}")
    if timed:
        x_lib = x.permute(0, 3, 1, 2)  # NCHW channels_last: the same memory
        w_lib = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        fields["ms"] = time_ms(lambda: fn(x, k), 10)
        if dtype == torch.float32:
            old = conv_probe.cp_async(fn, x, k)
            old_err = (old - want).abs()
            if (old_err / tol).max().item() > 1.0:
                raise AssertionError(f"{name} {shape}: the cp.async path disagrees")
            fields["cp_async_max_abs_err"] = old_err.max().item()
            cp_ms = [time_ms(lambda: conv_probe.cp_async(fn, x, k), 10) for _ in range(2)]
            fields["ms"] = (fields["ms"] + time_ms(lambda: fn(x, k), 10)) / 2
            fields["cp_async_ms"] = sum(cp_ms) / 2
            del old, old_err
        fields["plain_ms"] = time_ms(lambda: conv_probe.conv3x3_nobias_plain(x, k), 3)
        fields["library_ms"] = time_ms(lambda: F.conv2d(x_lib, w_lib, padding=1), 10)
        peak = PEAK_F32_TC_FLOPS if dtype == torch.float32 else PEAK_BF16_TC_FLOPS
        nbytes = (x.numel() + k.numel() + got.numel()) * x.element_size()
        fields["bound_ms"], fields["bound_by"], direct = conv_bound((b, cin, h, w, cout), nbytes,
                                                                    peak)
        fields["direct_floor_ms"] = 1e3 * direct / peak
    emit("probes", **fields)
    del x, k, got, again, want, diff, tol
    return fields


def phase_probes() -> dict:
    """P1-P5 against their plain versions on the card, TF32 off, each run
    twice for the same bits.

    P1 at the probe's x (PROBE_SHAPE in NHWC) and MOMENT_ODD_SHAPES; P2-P5
    at PROBE_SHAPE, at the shapes their CLI runs them (CONV_PROBE_CLI) and
    at CONV_PROBE_ODD; every case in f32 and bf16. Timed: PROBE_SHAPE in
    both dtypes, the CLI shapes in bf16 (the CLI's dtype). P2-P5 must run
    the TMA path in bf16 at their CLI shape and in f32 at PROBE_SHAPE. →
    the ``kernels`` line's rows: P1 summed over one call in each dtype at
    PROBE_SHAPE (what one pass of its CLI runs), P2-P5 at their CLI shape in
    bf16 and at PROBE_SHAPE in f32 (``*_f32``)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, cin, h, w, cout = PROBE_SHAPE
    results = {}
    p1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(b, h, w, cin)] + MOMENT_ODD_SHAPES:
            f = _moments_case(shape, dtype, gen, shape == (b, h, w, cin))
            if "ms" in f:  # the error of P1's outputs, the mean and the variance
                p1["max_abs_err"] = max(p1["max_abs_err"], f["mean_abs_err"], f["var_abs_err"])
                for key in ("ms", "plain_ms", "library_ms"):
                    p1[key] += f[key]
                size = torch.empty((), dtype=dtype).element_size()
                add_bound(p1, 3 * b * h * w * cin, size * b * h * w * cin + 8 * cin)
    results["moments"] = close_bound(p1)
    for dtype in (torch.float32, torch.bfloat16):
        for name in PROBE_CONV_KERNELS:
            cases = [(b, h, w, cin, cout)] + [s for n, s in CONV_PROBE_ODD if n == name]
            if dtype == torch.bfloat16 and CONV_PROBE_CLI[name] not in cases:
                cases.append(CONV_PROBE_CLI[name])
            for shape in cases:
                timed = shape == (b, h, w, cin, cout) or (
                    dtype == torch.bfloat16 and shape == CONV_PROBE_CLI[name])
                f = _conv_probe_case(name, shape, dtype, gen, timed)
                if dtype == torch.bfloat16 and shape == CONV_PROBE_CLI[name]:
                    if f["path"] != "tma":
                        raise AssertionError(f"{name} at its CLI shape ran {f['path']}, not tma")
                    results[name] = {k: f[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                       "library_ms", "bound_ms", "bound_by")}
                if dtype == torch.float32 and shape == (b, h, w, cin, cout):
                    if f["path"] != "tma":
                        raise AssertionError(f"{name} f32 at {shape} ran {f['path']}, not tma")
                    results[f"{name}_f32"] = {k: f[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                    emit("probes_f32", kernel=name, shape=list(shape), ms=f["ms"],
                         cp_async_ms=f["cp_async_ms"], library_ms=f["library_ms"],
                         bound_ms=f["bound_ms"], direct_floor_ms=f["direct_floor_ms"],
                         speedup_over_cp_async=f["cp_async_ms"] / f["ms"],
                         card=torch.cuda.get_device_name(0))
    return results


def phase_probe_cli() -> dict:
    """The probes' CLIs as a user runs them on the card: ``bench_moments``
    (f32 and bf16 at the probe's x), ``bench_conv3x3`` at its default
    (bf16, Cin = Cout = 64: P5), at Cin 128 (P2 and P3) and at Cin 96 (P4),
    and its ``--check`` (P2-P5 in f32 at Cin 64, the probe's parity mode),
    each of which holds its kernels to a reference itself. → launches."""
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rcs = [bench_moments.main([]), bench_conv3x3.main([]),
               bench_conv3x3.main(["32", "320", "128", "128"]),
               bench_conv3x3.main(["32", "320", "96", "96"]), bench_conv3x3.main(["--check"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if any(rcs):
        raise AssertionError(f"probe CLIs returned {rcs}")
    require_launches("probe_cli", counts, PROBE_KERNELS)
    emit("probe_cli", seconds=wall, output=out.getvalue().splitlines(), launches=counts)
    return counts


class RecordLog:
    """The logger ``train_net`` writes to, keeping its records."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, record: dict) -> None:
        self.records.append(dict(record))


def timed_steps(step, tensors, n: int) -> tuple[list, list]:
    """``n`` train steps on one batch, each timed with CUDA events →
    (losses, step ms)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    events[0].record()
    for e in events[1:]:
        losses.append(step(*tensors))
        e.record()
    events[-1].synchronize()
    return [float(v) for v in losses], [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def check_first_gradients(phase: str, model: torch.nn.Module) -> None:
    """Every parameter's gradient present, finite and nonzero."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
    if bad:
        raise AssertionError(f"{phase}: after step 1, gradients missing, not finite or zero: {bad}")


def path_batch(cfg: dict, seed: int = 2) -> tuple:
    """One batch of the config's batch size at 320x320, with its inputs."""
    bs = cfg["batch_size"]
    ds = synthetic(bs, IMAGE, seed=seed, num_inputs=cfg.get("num_inputs", 1))
    return (np.stack([ds[i][0] for i in range(bs)]), np.stack([ds[i][1] for i in range(bs)]),
            np.ones((bs,), np.float32))


def phase_train(config: dict) -> tuple[dict, dict, dict]:
    """One epoch of ``train_net`` at 320x320, batch 32 → (launches, the
    initial state dict, the train config).

    Before it, ``make_train_step`` on the same model and its first batch:
    every parameter's first gradient is checked, and after WARMUP_STEPS
    the device time of TIMED_STEPS steps is taken with CUDA events. The
    initial weights are then restored, so ``train_net`` starts from them.
    """
    cfg = dict(config, epochs=1)
    t0 = time.perf_counter()
    train_ds = synthetic(TRAIN_N, IMAGE, seed=2)
    val_ds = synthetic(TRAIN_VAL_N, IMAGE, seed=3)
    data_s = time.perf_counter() - t0
    state = add_uncertainty(
        build_trunk(cfg), cfg,
        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
    )
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    bs = cfg["batch_size"]
    batch = train.put_batch(np.stack([train_ds[i][0] for i in range(bs)]),
                            np.stack([train_ds[i][1] for i in range(bs)]),
                            np.ones((bs,), np.float32), torch.device(DEVICE))
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(state.model, head_loss_pe_fn(state.uncertainty_type), cfg, opt)
    reset_counts()
    losses = [float(step(*batch))]
    require_k1_per_step("train", read_counts(), 1)
    check_first_gradients("train", state.model)
    for _ in range(WARMUP_STEPS - 1):
        losses.append(float(step(*batch)))
    _, step_ms = timed_steps(step, batch, TIMED_STEPS)
    losses.append(float(step(*batch)))
    state.model.load_state_dict(init)
    del opt, step, batch

    log = RecordLog()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.train_net(state, train_ds, val_ds, None, epochs=1, batch_size=bs, lr=cfg["lr"],
                    validate_every=1, config=cfg, logger=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require_launches("train", counts, ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"])
    epoch = {k: v for r in log.records for k, v in r.items()}
    if epoch["iter"] != TRAIN_N // bs:
        raise AssertionError(f"train took {epoch['iter']} steps, not {TRAIN_N // bs}")
    if not np.isfinite(losses + [epoch["train_loss"], epoch["val_loss"]]).all():
        raise AssertionError(f"train losses not finite: {losses} {epoch}")
    median_ms = float(np.median(step_ms))
    train_s = epoch["time/epoch_s"] - epoch["time/val_s"] - epoch["time/checkpoint_s"]
    emit("train", images=TRAIN_N, batch=bs, image=IMAGE, steps=epoch["iter"],
         median_step_ms=median_ms, imgs_per_sec=1e3 * bs / median_ms, step_ms=step_ms,
         step_losses=losses, epoch_imgs_per_sec=TRAIN_N / train_s, epoch=epoch,
         seconds=wall, data_seconds=data_s,
         params_with_gradient=sum(1 for _ in state.model.parameters()), launches=counts)
    return counts, init, cfg


def _feeds_batchnorm(name: str) -> bool:
    """A conv bias that a BatchNorm follows (DoubleConv's convs 0 and 3)."""
    return re.search(r"double_conv\.[03]\.bias$", name) is not None


def _train_step_once(init: dict, cfg: dict, device: str, dtype: torch.dtype, batch) -> tuple:
    """One train step of ``init`` on ``device`` in ``dtype`` → (loss,
    gradients, BatchNorm running statistics), as f64 CPU tensors."""
    st = add_uncertainty(build_trunk(cfg), cfg, device=device)
    st.model.load_state_dict(init)
    st.model.to(dtype)
    opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(st.model, head_loss_pe_fn(st.uncertainty_type), cfg, opt)
    x, y, mask = (t.to(dtype) for t in train.put_batch(*batch, torch.device(device)))
    loss = float(step(x, y, mask))
    grads = {n: p.grad.detach().double().cpu() for n, p in st.model.named_parameters()}
    stats = {n: b.detach().double().cpu() for n, b in st.model.named_buffers() if "running" in n}
    return loss, grads, stats


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms, so that two steps on
    the same inputs round alike."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def plain_versions():
    """The kernels' plain versions in place of their wrappers, on the card:
    the reference for the kernels' step. Nothing is counted."""
    saved = (upsample.upsample2x_fwd, upsample.upsample2x_bwd, pool.max_pool2x2_bwd)
    upsample.upsample2x_fwd = upsample.upsample2x_plain
    upsample.upsample2x_bwd = upsample.upsample2x_bwd_plain
    pool.max_pool2x2_bwd = pool.max_pool2x2_bwd_plain
    try:
        yield
    finally:
        upsample.upsample2x_fwd, upsample.upsample2x_bwd, pool.max_pool2x2_bwd = saved


def _rel_errors(got: dict, want: dict) -> dict:
    """Relative L2 error per tensor. A conv bias that a BatchNorm follows
    has an exact gradient of 0 (train-mode BatchNorm subtracts the batch
    mean), so every side holds rounding noise there: its error is taken
    relative to the same conv's weight gradient instead."""
    out = {}
    for n, w in want.items():
        ref = want[n[: -len("bias")] + "weight"] if _feeds_batchnorm(n) else w
        out[n] = ((got[n] - w).norm() / ref.norm()).item()
    return out


def _differ(a: tuple, b: tuple) -> list:
    """The names of the gradients and statistics that are not bit-identical."""
    return [n for part in (1, 2) for n in a[part] if not torch.equal(a[part][n], b[part][n])]


def phase_gradcheck(init: dict, cfg: dict, phase: str = "gradcheck",
                    card_in_f64: bool = False) -> None:
    """One train step of the same weights (batch 2, 64x64): on the card
    with the kernels, on the card with their plain versions, on the CPU
    (plain versions) in f32 and on the CPU in f64.

    - The kernels against the plain versions on the card, with cuDNN held
      to deterministic algorithms: the loss, every gradient and every
      BatchNorm statistic bit-identical. The kernels are exact, so any
      difference is a fault on the gradient path.
    - The card (cuDNN's default algorithms) against the CPU's f32 step and
      the f64 step: relative L2 error per tensor ≤ GRAD_RTOL, BatchNorm
      running statistics ≤ STAT_RTOL. The step's gradient is a
      discontinuous function of its input (ReLU, max-pool and pinball
      kinks, amplified by train-mode BatchNorm over 2 images): one f32 ulp
      on every input pixel moves the f64 step's gradients by up to 2.1e-3
      per tensor, and the card's f32 step, with or without cuDNN, lands
      2.7e-3 to 3.1e-3 from the f64 one. A wrong or missing gradient path
      is off by order 1. The running statistics come from the forward
      alone (about 1e-6).
    - With ``card_in_f64`` the card's step in the second check runs in f64,
      with the plain versions (the kernels take f32; the first check holds
      them to the plain versions), against the CPU's f64 step, with the
      same bars; the f32 steps' distances are reported. For the gaussian
      head no f32 step meets GRAD_RTOL: its NLL divides by ReLU'd variances
      just above eps at many pixels at random init, where an f32 conv's
      rounding is a large share of the variance (the CPU's f32 step lands
      up to 6.2e-2 per tensor from the f64 one, the card's 1.8e-2).
    """
    ds = synthetic(2, 64, seed=6)
    batch = (np.stack([ds[i][0] for i in range(2)]), np.stack([ds[i][1] for i in range(2)]),
             np.ones((2,), np.float32))
    gpu = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    with deterministic_cudnn():
        kernels = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
        with plain_versions():
            plain = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    cpu = _train_step_once(init, cfg, "cpu", torch.float32, batch)
    f64 = _train_step_once(init, cfg, "cpu", torch.float64, batch)
    differ = _differ(kernels, plain) + ([] if kernels[0] == plain[0] else ["loss"])
    held, ref = gpu, cpu
    if card_in_f64:
        with plain_versions():
            held = _train_step_once(init, cfg, DEVICE, torch.float64, batch)
        ref = f64
    grad_err, stat_err = _rel_errors(held[1], ref[1]), _rel_errors(held[2], ref[2])
    gpu_f64, cpu_f64 = _rel_errors(held[1], f64[1]), _rel_errors(cpu[1], f64[1])
    worst_g = max(grad_err, key=grad_err.get)
    worst_s = max(stat_err, key=stat_err.get)
    worst_f64 = max(gpu_f64, key=gpu_f64.get)
    f32 = {}
    if card_in_f64:
        f32 = {"f32_max_grad_err": max(_rel_errors(gpu[1], cpu[1]).values()),
               "f32_max_grad_err_gpu_vs_f64": max(_rel_errors(gpu[1], f64[1]).values())}
    emit(phase, uncertainty_type=cfg["uncertainty_type"], card_dtype="float64" if card_in_f64
         else "float32", batch=2, image=64, loss_gpu=held[0], loss_cpu=ref[0],
         loss_f64=f64[0], kernels_vs_plain_differ=differ, grad_rtol=GRAD_RTOL,
         max_grad_err=grad_err[worst_g], worst_grad=worst_g, stat_rtol=STAT_RTOL,
         max_stat_err=stat_err[worst_s], worst_stat=worst_s,
         max_grad_err_gpu_vs_f64=gpu_f64[worst_f64], worst_grad_gpu_vs_f64=worst_f64,
         max_grad_err_cpu_vs_f64=max(cpu_f64.values()), **f32, grad_err=grad_err,
         grad_err_gpu_vs_f64=gpu_f64, grad_err_cpu_vs_f64=cpu_f64)
    if differ:
        raise AssertionError(f"{phase}: the kernels' train step differs from the plain "
                             f"versions' in {differ}")
    if max(grad_err[worst_g], gpu_f64[worst_f64]) > GRAD_RTOL or stat_err[worst_s] > STAT_RTOL:
        raise AssertionError(
            f"{phase}: the card's train step is off: {worst_g} {grad_err[worst_g]} against the "
            f"CPU, {worst_f64} {gpu_f64[worst_f64]} against f64, {worst_s} {stat_err[worst_s]}"
        )


def phase_router(phase: str = "router", overrides: dict | None = None,
                 kernels: list | None = None) -> dict:
    """``scripts/router.main`` on the synthetic experiment, on the card,
    with the config's parameters set to ``overrides``; ``kernels`` must be
    launched on the way."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(ROUTER_CONFIG) as fh:
            sweep = yaml.safe_load(fh)
        for key, value in (overrides or {}).items():
            sweep["parameters"][key] = {"value": value}
        sweep["parameters"]["output_dir"] = {"value": os.path.join(tmp, "outputs")}
        sweep["parameters"]["checkpoint_dir"] = {"value": os.path.join(tmp, "checkpoints")}
        cfg_path = os.path.join(tmp, "config.yml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(sweep, fh)
        (cfg,) = router.load_config(cfg_path)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the router's progress log
            rc = router.main(["--config", cfg_path, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"router.main returned {rc}")
        paths = [router.results_filename(cfg), router.loss_table_filename(cfg),
                 calibrated_checkpoint_path(cfg["checkpoint_dir"], cfg)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise AssertionError(f"router artifacts missing: {missing}")
        with open(paths[0], "rb") as fh:
            results = pickle.load(fh)
        with open(paths[1], "rb") as fh:
            table = pickle.load(fh)
        names = sorted(os.listdir(cfg["output_dir"])) + sorted(os.listdir(cfg["checkpoint_dir"]))
    if sorted(results) != RESULT_KEYS:
        raise AssertionError(f"results keys {sorted(results)} != the JAX router's {RESULT_KEYS}")
    grid = lambda_grid(cfg)
    if results["lhat"] not in grid:
        raise AssertionError(f"λ̂ {results['lhat']} is not a point of the λ grid")
    if table.ndim != 2 or table.shape[1] != cfg["num_lambdas"] or not np.isfinite(table).all():
        raise AssertionError(f"bad loss table: shape {table.shape}")
    require_launches(phase, counts, kernels or DEFAULT_PATH_KERNELS)
    emit(phase, conv_backend=cfg.get("conv_backend", "auto"), seconds=wall, epochs=cfg["epochs"], images=cfg["num_examples"],
         image=cfg["image_size"], lhat=float(results["lhat"]), risk=float(results["risk"]),
         table_shape=list(table.shape), artifacts=names, launches=counts)
    return counts


def calibrate_and_serve(tag: str, state: UQState, config: dict, calib, serve,
                        kernels: list) -> tuple[UQState, np.ndarray, dict, dict]:
    """``calibrate_model`` on ``calib``, then ``infer.main`` on ``serve``
    from the saved checkpoint and a config file of ``config`` → (the
    calibrated state, the served inputs, the launches, the calibration
    seconds and serving images/s). Phases
    ``{tag}calibrate`` and ``{tag}serve``; ``kernels`` must be launched on
    each of the two paths."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, table = calibrate_model(state, calib, config)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_counts = read_counts()
    if table.shape != (len(calib), config["num_lambdas"]) or not np.isfinite(table).all():
        raise AssertionError(f"bad calibration table: shape {table.shape}")
    if not (0.0 <= table.min() and table.max() <= 1.0):
        raise AssertionError("calibration table outside [0, 1]")
    require_launches(f"{tag}calibrate", calib_counts, ["loss_table"] + kernels)
    emit(f"{tag}calibrate", conv_backend=config.get("conv_backend", "auto"), images=len(calib),
         num_lambdas=config["num_lambdas"], lhat=state.lhat, seconds=calib_s,
         launches=calib_counts)

    xs = np.stack([serve[i][0] for i in range(len(serve))])
    ys = np.stack([serve[i][1] for i in range(len(serve))])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_calibrated_checkpoint(state, config, tmp)
        cfg_path = os.path.join(tmp, "config.yml")
        with open(cfg_path, "w") as fh:
            yaml.safe_dump(config, fh)
        np.save(os.path.join(tmp, "serve.npy"), xs)
        out_dir = os.path.join(tmp, "out")
        reset_counts()
        rc = infer.main([
            "--config", cfg_path, "--checkpoint", ckpt, "--input",
            os.path.join(tmp, "serve.npy"), "--output", out_dir,
            "--batch-size", "32", "--device", DEVICE,
        ])
        torch.cuda.synchronize()
        serve_counts = read_counts()
        if rc != 0:
            raise AssertionError(f"infer.main returned {rc}")
        with np.load(os.path.join(out_dir, "serve_intervals.npz")) as z:
            out = {k: z[k] for k in z.files}
        with open(os.path.join(out_dir, "inference_summary.json")) as fh:
            summary = json.load(fh)
    if sorted(out) != ["lam", "lower", "prediction", "upper"]:
        raise AssertionError(f"unexpected npz keys {sorted(out)}")
    lo, pred, hi = out["lower"], out["prediction"], out["upper"]
    for a in (lo, pred, hi):
        if a.shape != ys.shape or not np.isfinite(a).all():
            raise AssertionError(f"bad interval map: shape {a.shape}")
    if not ((lo <= pred).all() and (pred <= hi).all()):
        raise AssertionError("intervals not ordered lower <= prediction <= upper")
    if float(out["lam"]) != state.lhat:
        raise AssertionError(f"served λ {float(out['lam'])} != calibrated λ̂ {state.lhat}")
    require_launches(f"{tag}serve", serve_counts, ["upsample2x"] + kernels)
    emit(f"{tag}serve", conv_backend=config.get("conv_backend", "auto"), images=len(serve),
         imgs_per_sec=summary["imgs_per_sec"], seconds=summary["seconds"], lam=summary["lam"],
         miscoverage=float(((ys < lo) | (ys > hi)).mean()), launches=serve_counts)
    launches = {k: calib_counts[k] + serve_counts[k] for k in KERNELS}
    return state, xs, launches, {"calibration_s": calib_s,
                                 "serve_imgs_per_sec": summary["imgs_per_sec"]}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _against_default(phase: str, cfg: dict, config: dict, init: dict, batch,
                     default_step: tuple, trained: dict, x: torch.Tensor) -> None:
    """One train step of ``init`` under ``cfg`` against the same step
    under the default config ``config`` (``default_step``), and the eval
    forward of ``trained`` under both: loss within FUSED_LOSS_RTOL, every
    gradient within GRAD_RTOL (a tripwire: see phase_gradcheck), every
    running statistic within FUSED_STAT_RTOL, the eval output within
    FUSED_EVAL_RTOL, relative L2."""
    step = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    grad_err, stat_err = _rel_errors(step[1], default_step[1]), _rel_errors(step[2], default_step[2])
    loss_err = abs(step[0] - default_step[0]) / abs(default_step[0])
    outs = []
    for c in (cfg, config):
        st = add_uncertainty(build_trunk(c), c, device=DEVICE)
        st.model.load_state_dict(trained)
        outs.append(st.forward(x))
        del st
    eval_err = _rel_l2(outs[0], outs[1])
    worst_g = max(grad_err, key=grad_err.get)
    worst_s = max(stat_err, key=stat_err.get)
    emit(phase, conv_backend=cfg["conv_backend"], batch=len(batch[0]), loss=step[0],
         loss_default=default_step[0], loss_rel_err=loss_err, max_grad_err=grad_err[worst_g],
         worst_grad=worst_g, grad_rtol=GRAD_RTOL, max_stat_err=stat_err[worst_s],
         worst_stat=worst_s, stat_rtol=FUSED_STAT_RTOL, eval_rel_err=eval_err,
         eval_rtol=FUSED_EVAL_RTOL, grad_err=grad_err)
    if (loss_err > FUSED_LOSS_RTOL or grad_err[worst_g] > GRAD_RTOL
            or stat_err[worst_s] > FUSED_STAT_RTOL or eval_err > FUSED_EVAL_RTOL):
        raise AssertionError(f"{phase}: {cfg['conv_backend']} is off the default config: loss "
                             f"{loss_err}, {worst_g} {grad_err[worst_g]}, {worst_s} "
                             f"{stat_err[worst_s]}, eval {eval_err}")


def require_tma_per_step(phase: str, counts: dict, steps: int) -> None:
    """K5's and K6's f32 launches in ``steps`` pallas_fused UNet train steps
    at batch 32, 320x320: one per K4 (K6: but the stem's, ``conv_sites``),
    on the TMA path wherever ``conv_bwd.wgrad_f32_plan`` /
    ``dgrad_f32_plan`` takes the shape (K5: all but the stem's; K6: all)."""
    for kernel, plan in (("wgrad3x3", conv_bwd.wgrad_f32_plan),
                         ("dgrad3x3", conv_bwd.dgrad_f32_plan)):
        sites = conv_sites("pallas_fused")[kernel]
        want = len(sites), sum(plan(b, ci, co, h, w) is not None
                               for (b, ci, h, w, co), _ in sites)
        got = counts[kernel] / steps, counts[f"{kernel}_tma"] / steps
        if got != want:
            raise AssertionError(f"{phase}: {CONV_PHASES[kernel]} launches a step (all, TMA "
                                 f"path) {got}, want {want}")


def phase_fused(config: dict, calib, serve) -> dict:
    """The model under ``conv_backend: pallas_fused`` at 320x320, batch 32:
    ``make_train_step`` from seed-5 weights (every first gradient finite
    and nonzero; the median of TIMED_STEPS steps after WARMUP_STEPS), one
    step and the eval forward against the default config, and the same
    for ``conv_backend: pallas``; then calibrate and serve the seed-0
    weights of phases 5-6. → launches."""
    cfg = dict(config, conv_backend="pallas_fused")
    bs = cfg["batch_size"]
    batch = path_batch(cfg)
    state = add_uncertainty(
        build_trunk(cfg), cfg,
        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
    )
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(state.model, head_loss_pe_fn(state.uncertainty_type), cfg, opt)
    tensors = train.put_batch(*batch, torch.device(DEVICE))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(*tensors))]
    first_s = time.perf_counter() - t0
    check_first_gradients("fused", state.model)
    for _ in range(WARMUP_STEPS - 1):
        losses.append(float(step(*tensors)))
    _, step_ms = timed_steps(step, tensors, TIMED_STEPS)
    train_counts = read_counts()
    if not np.isfinite(losses).all():
        raise AssertionError(f"fused train losses not finite: {losses}")
    require_launches("fused_train", train_counts,
                     ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"] + CONV_KERNELS)
    steps = WARMUP_STEPS + TIMED_STEPS
    require_tma_per_step("fused_train", train_counts, steps)
    median_ms = float(np.median(step_ms))
    emit("fused_train", conv_backend="pallas_fused", batch=bs, image=IMAGE, steps=steps,
         median_step_ms=median_ms, imgs_per_sec=1e3 * bs / median_ms, step_ms=step_ms,
         first_step_s=first_s, step_losses=losses,
         launches_per_step={k: v / steps for k, v in train_counts.items()},
         launches=train_counts)
    trained = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del opt, step, tensors

    x = nchw_from_nhwc(batch[0], DEVICE)
    default_step = _train_step_once(init, config, DEVICE, torch.float32, batch)
    _against_default("fused_vs_default", cfg, config, init, batch, default_step, trained, x)
    pallas_cfg = dict(config, conv_backend="pallas")
    reset_counts()
    _against_default("pallas_vs_default", pallas_cfg, config, init, batch, default_step,
                     trained, x)
    pallas_counts = read_counts()
    require_launches("pallas_vs_default", pallas_counts, ["conv3x3"])
    del default_step, x

    # calibrate and serve the default path's seed-0 weights, so that the
    # two configs' times and λ̂ compare (λ̂ moves the host's bound work)
    del state
    state = add_uncertainty(
        build_trunk(cfg), cfg,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    _, _, launches, _ = calibrate_and_serve("fused_", state, cfg, calib, serve,
                                         ["conv3x3", "conv3x3_bn_act"])
    for name in KERNELS:
        launches[name] += train_counts[name] + pallas_counts[name]
    return launches


def train_steps(phase: str, state: UQState, cfg: dict, batch, kernels: list,
                **hooks) -> tuple:
    """PATH_STEPS steps of ``make_train_step`` on ``batch`` (raw, with the
    step's ``preprocess`` or ``preprocess_pair`` in ``hooks``), counted →
    (launches, losses, step ms); every loss finite and every first gradient
    finite and nonzero, ``kernels`` launched."""
    opt = torch.optim.Adam(state.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(state.model, head_loss_pe_fn(state.uncertainty_type), cfg, opt,
                                 **hooks)
    tensors = train.put_batch(*batch, torch.device(DEVICE),
                              raw_input=hooks.get("preprocess") is not None)
    reset_counts()
    losses = [float(step(*tensors))]
    check_first_gradients(phase, state.model)
    more, step_ms = timed_steps(step, tensors, PATH_STEPS - 1)
    counts = read_counts()
    losses += more
    if not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: train losses not finite: {losses}")
    require_launches(phase, counts, kernels)
    require_k1_per_step(phase, counts, PATH_STEPS)
    return counts, losses, step_ms


def k2_on_own_params(phase: str, state: UQState, config: dict, calib) -> None:
    """K2 on the interval params of ``state`` over one calibration batch,
    at the config's calibration grid: 0 cells apart from the plain version
    and the same bits twice. Not counted."""
    bs = config["batch_size"]
    x = nchw_from_nhwc(np.stack([calib[i][0] for i in range(bs)]), DEVICE)
    y = nchw_from_nhwc(np.stack([calib[i][1] for i in range(bs)]), DEVICE)
    params = state.interval_params(state.forward(x))
    grid = lambda_grid(config)
    lam = torch.from_numpy((grid - (grid[1] - grid[0])).astype(np.float32)).to(DEVICE)
    maps = [t.reshape(bs, -1).float().contiguous() for t in (params.pred, y, params.dl, params.du)]
    got = loss_table.loss_table(*maps, lam)
    again = loss_table.loss_table(*maps, lam)
    want = loss_table.loss_table_plain(*maps, lam)
    torch.cuda.synchronize()
    differ = int((got != want).sum().item())
    zero = {k: int((m == 0).sum().item()) for k, m in (("dl", maps[2]), ("du", maps[3]))}
    emit(phase, uncertainty_type=config["uncertainty_type"], model=config.get("model", "UNet"),
         conv_backend=config.get("conv_backend", "auto"), shape=list(maps[0].shape),
         num_lambdas=int(lam.numel()), cells_differ=differ, cells=got.numel(),
         bit_identical=torch.equal(got, again), zero_slopes=zero, pixels=maps[0].numel())
    if differ or not torch.equal(got, again):
        raise AssertionError(f"{phase}: K2 on the {config['uncertainty_type']} head's interval "
                             f"params: {differ} cells differ from the plain version, the same "
                             f"bits twice: {torch.equal(got, again)}")


def phase_heads(config: dict, calib, serve) -> dict:
    """The main path for each head of HEAD_TYPES at the main path's config
    (UNet, 320x320, batch 32, cuDNN): PATH_STEPS train steps from seed-5
    weights, the gradcheck of phase 10 for that head (the card in f64 for
    F64_GRADCHECK_HEADS), then
    calibration of the trained model on ``calib`` and serving of ``serve``
    (phases heads_{type}_calibrate and heads_{type}_serve), and K2 on the
    head's own interval params. → launches of the train, calibrate and
    serve paths."""
    launches = {k: 0 for k in KERNELS}
    batch = path_batch(config)
    for utype in HEAD_TYPES:
        cfg = dict(config, uncertainty_type=utype, num_softmax=NUM_SOFTMAX)
        state = add_uncertainty(
            build_trunk(cfg), cfg,
            generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
        )
        init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        train_counts, losses, step_ms = train_steps(
            f"heads_{utype}_train", state, cfg, batch,
            ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"])
        phase_gradcheck(init, cfg, "heads_gradcheck", utype in F64_GRADCHECK_HEADS)
        state, _, counts, times = calibrate_and_serve(f"heads_{utype}_", state, cfg, calib,
                                                      serve, [])
        k2_on_own_params("heads_k2", state, cfg, calib)
        median_ms = float(np.median(step_ms))
        emit("heads", uncertainty_type=utype, batch=cfg["batch_size"], image=IMAGE,
             steps=PATH_STEPS, median_step_ms=median_ms, imgs_per_sec=1e3 * cfg["batch_size"]
             / median_ms, step_ms=step_ms, step_losses=losses, lhat=state.lhat, **times,
             launches={k: train_counts[k] + counts[k] for k in KERNELS})
        for name in KERNELS:
            launches[name] += train_counts[name] + counts[name]
        del state, init
    return launches


def phase_wnet(config: dict) -> dict:
    """WNet + quantile head on 2-channel 320x320 inputs, batch 32: under
    ``xla`` and then ``pallas_fused`` from the same seed-5 weights,
    PATH_STEPS train steps (K3-K6 required under ``pallas_fused``), the
    fused step and eval forward against the default config's
    (``_against_default``), then calibration on 128 and serving of 64
    2-channel images under each. → launches."""
    cfg = dict(config, model="WNet", num_inputs=2)
    calib = synthetic(CALIB_N, IMAGE, seed=0, num_inputs=2)
    serve = synthetic(SERVE_N, IMAGE, seed=1, num_inputs=2)
    batch = path_batch(cfg)
    launches = {k: 0 for k in KERNELS}
    init = None
    for backend in ("xla", "pallas_fused"):
        c = dict(cfg, conv_backend=backend)
        fused = backend == "pallas_fused"
        state = add_uncertainty(
            build_trunk(c), c, generator=torch.Generator(device=DEVICE).manual_seed(5),
            device=DEVICE,
        )
        if init is None:
            init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        train_counts, losses, step_ms = train_steps(
            f"wnet_{backend}_train", state, c, batch,
            ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"] + (CONV_KERNELS if fused else []))
        median_ms = float(np.median(step_ms))
        emit("wnet_train", conv_backend=backend, batch=c["batch_size"], image=IMAGE,
             steps=PATH_STEPS, median_step_ms=median_ms, imgs_per_sec=1e3 * c["batch_size"]
             / median_ms, step_ms=step_ms, step_losses=losses, launches=train_counts)
        if fused:
            trained = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            xla = dict(cfg, conv_backend="xla")
            default_step = _train_step_once(init, xla, DEVICE, torch.float32, batch)
            _against_default("wnet_fused_vs_default", c, xla, init, batch, default_step,
                             trained, nchw_from_nhwc(batch[0], DEVICE))
            del default_step, trained
        state, _, counts, _ = calibrate_and_serve(
            f"wnet_{backend}_", state, c, calib, serve,
            ["conv3x3", "conv3x3_bn_act"] if fused else [])
        for name in KERNELS:
            launches[name] += train_counts[name] + counts[name]
        del state
    return launches


def eval_against_f32(phase: str, cfg: dict, weights: dict, x: torch.Tensor,
                     kernels: list) -> dict:
    """The eval forward of ``weights`` under ``cfg`` in bf16 against the
    same under ``cfg`` in f32 (uncounted): float32 output, finite, within
    BF16_EVAL_RTOL relative L2; the bf16 forward counted, ``kernels``
    launched. → its launches."""
    outs = []
    for dtype in ("float32", "bfloat16"):
        c = dict(cfg, compute_dtype=dtype)
        st = add_uncertainty(build_trunk(c), c, device=DEVICE)
        st.model.load_state_dict(weights)
        reset_counts()
        outs.append(st.forward(x))
        torch.cuda.synchronize()
        del st
    counts = read_counts()
    err = _rel_l2(outs[1], outs[0])
    emit(phase, model=cfg.get("model", "UNet"), uncertainty_type=cfg["uncertainty_type"],
         conv_backend=cfg.get("conv_backend", "auto"), batch=x.shape[0], image=x.shape[-1],
         rel_l2_vs_f32=err, rtol=BF16_EVAL_RTOL, launches=counts)
    if outs[1].dtype != torch.float32 or not bool(torch.isfinite(outs[1]).all()):
        raise AssertionError(f"{phase}: the bf16 output is not finite float32")
    if err > BF16_EVAL_RTOL:
        raise AssertionError(f"{phase}: bf16 eval output {err} from the f32 one")
    require_launches(phase, counts, ["upsample2x"] + kernels)
    return counts


def phase_bf16(config: dict, calib, serve) -> dict:
    """``compute_dtype: bfloat16`` on the main path's UNet + quantile head at
    320x320, batch 32: under ``xla``, ``pallas`` and ``pallas_fused``
    (K3/K4 forward, K5/K6 backward in bf16), PATH_STEPS train steps from
    seed-5 weights (every first gradient finite and nonzero; step times),
    then calibration and serving of the trained model (phases
    bf16_{backend}_calibrate, _serve); under ``pallas_fused`` also
    calibration and serving of weights trained in f32 (PATH_STEPS steps of
    the default config), and the eval forward of those weights under each
    backend against the f32 one (bf16_vs_f32). → launches."""
    launches = {k: 0 for k in KERNELS}
    batch = path_batch(config)
    for backend in ("xla", "pallas", "pallas_fused"):
        cfg = dict(config, conv_backend=backend, compute_dtype="bfloat16")
        state = add_uncertainty(
            build_trunk(cfg), cfg,
            generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
        )
        train_counts, losses, step_ms = train_steps(
            f"bf16_{backend}_train", state, cfg, batch,
            ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"] + BF16_TRAIN_KERNELS[backend])
        state, _, counts, times = calibrate_and_serve(f"bf16_{backend}_", state, cfg, calib,
                                                      serve, BF16_KERNELS[backend])
        median_ms = float(np.median(step_ms))
        emit("bf16", conv_backend=backend, batch=cfg["batch_size"], image=IMAGE,
             steps=PATH_STEPS, median_step_ms=median_ms,
             imgs_per_sec=1e3 * cfg["batch_size"] / median_ms, step_ms=step_ms,
             step_losses=losses, lhat=state.lhat, **times,
             launches={k: train_counts[k] + counts[k] for k in KERNELS})
        for name in KERNELS:
            launches[name] += train_counts[name] + counts[name]
        del state

    f32 = add_uncertainty(
        build_trunk(config), config,
        generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE,
    )
    train_steps("bf16_f32_weights", f32, config, batch, [])
    trained = {k: v.detach().clone() for k, v in f32.model.state_dict().items()}
    del f32
    cfg = dict(config, conv_backend="pallas_fused", compute_dtype="bfloat16")
    state = add_uncertainty(build_trunk(cfg), cfg, device=DEVICE)
    state.model.load_state_dict(trained)
    state, _, counts, times = calibrate_and_serve("bf16_pallas_fused_f32_weights_", state, cfg,
                                                  calib, serve, BF16_KERNELS["pallas_fused"])
    emit("bf16", conv_backend="pallas_fused", weights="trained in f32", lhat=state.lhat,
         **times, launches=counts)
    for name in KERNELS:
        launches[name] += counts[name]
    del state
    x = nchw_from_nhwc(batch[0], DEVICE)
    for backend in ("xla", "pallas", "pallas_fused"):
        counts = eval_against_f32("bf16_vs_f32", dict(config, conv_backend=backend), trained, x,
                                  BF16_KERNELS[backend])
        for name in KERNELS:
            launches[name] += counts[name]
    return launches


@contextlib.contextmanager
def plain_conv_versions():
    """K3-K6's plain versions in place of their wrappers, on the card. Nothing
    is counted."""
    names = [(conv, "conv3x3_fwd", conv.conv3x3_plain),
             (conv, "conv3x3_bn_act_fwd", conv.conv3x3_bn_act_plain),
             (conv_bwd, "wgrad3x3", conv_bwd.wgrad3x3_plain),
             (conv_bwd, "dgrad3x3", conv_bwd.dgrad3x3_plain),
             (conv_bwd, "cotangent_nhwc", conv_bwd.cotangent_plain),
             (conv_bwd, "activation_nhwc", conv_bwd.activation_plain),
             (conv_bwd, "wgrad3x3_nhwc", conv_bwd.wgrad3x3_nhwc_plain),
             (conv_bwd, "dgrad3x3_nhwc", conv_bwd.dgrad3x3_nhwc_plain)]
    saved = [getattr(m, n) for m, n, _ in names]
    for m, n, fn in names:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for (m, n, _), fn in zip(names, saved):
            setattr(m, n, fn)


def _tree_rel(got: dict, want: dict) -> float:
    """Relative L2 error over every tensor of ``want`` together."""
    num = sum(float((got[n] - w).square().sum()) for n, w in want.items())
    return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5


def phase_bf16_gradcheck(config: dict) -> None:
    """One bf16 ``pallas_fused`` train step of seed-5 weights at batch 2,
    64x64: on the card with the kernels against the card with their plain
    versions (K1, K3-K7), and both against the CPU's f64 step of the same
    weights (the f32 config in f64, plain versions).

    Bars: the kernels and the plain versions round the same values to bf16
    but sum in f32 in other orders, so a value one bf16 ulp apart moves what
    follows it, through ReLU masks and train-mode BatchNorm: the loss within
    BF16_LOSS_RTOL, the whole gradient within BF16_GRAD_RTOL and each
    running statistic within BF16_STAT_RTOL relative L2; and the kernels'
    step no farther from f64 (whole gradient, worst statistic) than twice
    the plain versions' step is."""
    cfg = dict(config, conv_backend="pallas_fused", compute_dtype="bfloat16")
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    init = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    del st
    ds = synthetic(2, 64, seed=6)
    batch = (np.stack([ds[i][0] for i in range(2)]), np.stack([ds[i][1] for i in range(2)]),
             np.ones((2,), np.float32))
    with deterministic_cudnn():
        kernels = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
        with plain_versions(), plain_conv_versions():
            plain = _train_step_once(init, cfg, DEVICE, torch.float32, batch)
    f64 = _train_step_once(init, dict(cfg, compute_dtype="float32"), "cpu", torch.float64, batch)
    loss_err = abs(kernels[0] - plain[0]) / abs(plain[0])
    grad_err = _tree_rel(kernels[1], plain[1])
    stat_err = _rel_errors(kernels[2], plain[2])
    worst_s = max(stat_err, key=stat_err.get)
    vs64 = {"kernels_grad": _tree_rel(kernels[1], f64[1]), "plain_grad": _tree_rel(plain[1], f64[1]),
            "kernels_stat": max(_rel_errors(kernels[2], f64[2]).values()),
            "plain_stat": max(_rel_errors(plain[2], f64[2]).values())}
    emit("bf16_gradcheck", conv_backend="pallas_fused", batch=2, image=64,
         loss_kernels=kernels[0], loss_plain=plain[0], loss_f64=f64[0], loss_rel_err=loss_err,
         loss_rtol=BF16_LOSS_RTOL, grad_rel_err=grad_err, grad_rtol=BF16_GRAD_RTOL,
         max_stat_err=stat_err[worst_s], worst_stat=worst_s, stat_rtol=BF16_STAT_RTOL,
         vs_f64=vs64)
    if (loss_err > BF16_LOSS_RTOL or grad_err > BF16_GRAD_RTOL
            or stat_err[worst_s] > BF16_STAT_RTOL
            or vs64["kernels_grad"] > 2 * vs64["plain_grad"]
            or vs64["kernels_stat"] > 2 * vs64["plain_stat"]):
        raise AssertionError(f"bf16_gradcheck: the kernels' bf16 step is off the plain versions': "
                             f"loss {loss_err}, gradient {grad_err}, {worst_s} "
                             f"{stat_err[worst_s]}, against f64 {vs64}")


def _remat_step(cfg: dict, init: dict, tensors: tuple) -> dict:
    """One train step of ``init`` under ``cfg`` with cuDNN held to
    deterministic algorithms (loss, gradients, running statistics), then
    PATH_STEPS timed steps with its default ones, the peak of device memory
    over those."""
    st = add_uncertainty(build_trunk(cfg), cfg, device=DEVICE)
    st.model.load_state_dict(init)
    opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(st.model, head_loss_pe_fn(st.uncertainty_type), cfg, opt)
    with deterministic_cudnn():
        loss = step(*tensors)
    out = {"loss": loss.detach().clone(),
           "grads": {n: p.grad.detach().clone() for n, p in st.model.named_parameters()},
           "stats": {n: b.detach().clone() for n, b in st.model.named_buffers()}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, step_ms = timed_steps(step, tensors, PATH_STEPS)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["step_ms"] = float(np.median(step_ms))
    del st, opt, step
    return out


def _max_diffs(a: dict, b: dict) -> dict:
    """max |a - b| per tensor of the loss, the gradients and the statistics."""
    out = {"loss": (a["loss"] - b["loss"]).abs().item()}
    for part in ("grads", "stats"):
        for n, t in a[part].items():
            out[n] = (t.double() - b[part][n].double()).abs().max().item() if t.numel() else 0.0
    return out


def phase_remat(config: dict) -> dict:
    """``remat`` full, conv and bn on the main path's UNet at 320x320, batch
    32, under ``xla`` in f32 and ``pallas_fused`` in bf16, each beside remat
    off from the same seed-5 weights and batch: the peak of device memory
    and the median step ms over PATH_STEPS steps; the first step's loss,
    gradients and running statistics (cuDNN deterministic) within the
    difference between two remat-off steps, per tensor (0 where every op is
    deterministic). → the launches of the remat steps."""
    launches = {k: 0 for k in KERNELS}
    tensors = train.put_batch(*path_batch(config), torch.device(DEVICE))
    for backend, dtype in (("xla", "float32"), ("pallas_fused", "bfloat16")):
        base = dict(config, conv_backend=backend, compute_dtype=dtype)
        st = add_uncertainty(build_trunk(base), base,
                             generator=torch.Generator(device=DEVICE).manual_seed(5),
                             device=DEVICE)
        init = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        del st
        off = _remat_step(base, init, tensors)
        spread = _max_diffs(_remat_step(base, init, tensors), off)
        for mode in REMAT_MODES:
            reset_counts()
            got = _remat_step(dict(base, remat=mode), init, tensors)
            counts = read_counts()
            diff = _max_diffs(got, off)
            over = [n for n, d in diff.items() if d > spread[n]]
            emit("remat", remat=mode, conv_backend=backend, compute_dtype=dtype,
                 batch=config["batch_size"], image=IMAGE, peak_mib=got["peak_bytes"] / 2**20,
                 off_peak_mib=off["peak_bytes"] / 2**20, step_ms=got["step_ms"],
                 off_step_ms=off["step_ms"], loss=got["loss"].item(), off_loss=off["loss"].item(),
                 max_diff=max(diff.values()), max_off_spread=max(spread.values()),
                 tensors_over_spread=over, launches=counts)
            if over:
                raise AssertionError(f"remat {mode} under {backend} {dtype} is off remat off "
                                     f"beyond two remat-off steps' difference: {over}")
            if backend == "pallas_fused":
                require_launches(f"remat_{mode}", counts,
                                 ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"]
                                 + BF16_TRAIN_KERNELS["pallas_fused"])
            for name in KERNELS:
                launches[name] += counts[name]
            del got
        del off, init
    return launches


def phase_bf16_models(config: dict) -> dict:
    """One bf16 eval forward of each other head (seed-5 weights, cuDNN) on
    the main path's UNet and of WNet + quantile head under each conv
    backend, at 320x320, batch 32, each against the f32 forward of the same
    weights (``eval_against_f32``). → launches."""
    launches = {k: 0 for k in KERNELS}
    cases = [dict(config, uncertainty_type=u, num_softmax=NUM_SOFTMAX) for u in HEAD_TYPES]
    cases += [dict(config, model="WNet", num_inputs=2, conv_backend=b)
              for b in ("xla", "pallas", "pallas_fused")]
    for cfg in cases:
        st = add_uncertainty(build_trunk(cfg), cfg,
                             generator=torch.Generator(device=DEVICE).manual_seed(5),
                             device=DEVICE)
        weights = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        del st
        x = nchw_from_nhwc(path_batch(cfg)[0], DEVICE)
        counts = eval_against_f32("bf16_models", cfg, weights, x,
                                  BF16_KERNELS[cfg.get("conv_backend", "xla")])
        for name in KERNELS:
            launches[name] += counts[name]
    return launches


# the artifact against the live portable model when the two are not bit
# for bit (cuDNN may pick another algorithm): the bars of the JAX
# package's artifact test (tests/test_serving_export.py:74-84)
ARTIFACT_RTOL, ARTIFACT_ATOL = 1e-6, 1e-7
XLA_BACKENDS = {"conv_backend": "xla", "pool_backend": "xla", "resize_backend": "xla"}


def _write_config(tmp: str, tag: str, cfg: dict) -> str:
    path = os.path.join(tmp, f"{tag}.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _last_json(run, *args) -> tuple[int, dict]:
    """``run(*args)`` with its standard output captured → (its return code,
    the JSON object it printed last)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run(*args)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def calibrate_cli(phase: str, cfg: dict, weights: dict, calib, tmp: str,
                  kernels: list) -> tuple[str, dict]:
    """``weights`` saved as an uncalibrated training checkpoint of a model
    under ``cfg``, then ``scripts/calibrate.main`` on the card: λ̂ and the
    table bit for bit those of ``calibrate_model`` on the same state and
    ``calib``, ``kernels`` launched. → (the calibrated checkpoint, the
    CLI's launches)."""
    state = add_uncertainty(build_trunk(cfg), cfg, device=DEVICE)
    state.model.load_state_dict(weights)
    ckpt = checkpoint_path(os.path.join(tmp, phase), 1, cfg)
    save_checkpoint(ckpt, state.model, torch.optim.Adam(state.model.parameters()), None, 1)
    args = ["--config", _write_config(tmp, phase, cfg), "--checkpoint", ckpt,
            "--output-dir", os.path.join(tmp, phase, "out"), "--device", DEVICE]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, summary = _last_json(calibrate_script.main, args)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"{phase}: calibrate.main returned {rc}")
    with np.load(summary["loss_table"]) as z:
        table = z["loss_table"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_table = calibrate_model(state, calib, cfg)
    torch.cuda.synchronize()
    in_process_s = time.perf_counter() - t0
    same_table = bool(np.array_equal(table, want_table))
    emit(phase, conv_backend=cfg.get("conv_backend", "auto"),
         images=summary["num_calibration_examples"], num_lambdas=summary["num_lambdas"],
         lhat=summary["lhat"], lhat_calibrate_model=want.lhat, table_bit_identical=same_table,
         calibration_seconds=summary["calibration_seconds"], cli_wall_s=wall,
         calibrate_model_s=in_process_s, launches=counts)
    if summary["lhat"] != want.lhat or not same_table:
        raise AssertionError(f"{phase}: λ̂ {summary['lhat']} or the table differ from "
                             f"calibrate_model's (λ̂ {want.lhat})")
    if summary["num_calibration_examples"] != len(calib):
        raise AssertionError(f"{phase}: calibrated on {summary['num_calibration_examples']} "
                             f"images, not {len(calib)}")
    require_launches(phase, counts, ["loss_table", "upsample2x"] + kernels)
    return summary["checkpoint"], counts


def _serve_cli(args: list, out_dir: str) -> tuple[dict, dict, dict]:
    """``infer.main`` on the card → (the intervals, the summary, the
    launches)."""
    reset_counts()
    rc = infer.main(args + ["--output", out_dir, "--device", DEVICE])
    torch.cuda.synchronize()
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"infer.main returned {rc}")
    with np.load(os.path.join(out_dir, "serve_intervals.npz")) as z:
        out = {k: z[k] for k in z.files}
    with open(os.path.join(out_dir, "inference_summary.json")) as fh:
        summary = json.load(fh)
    return out, summary, counts


def _max_abs(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in ("lower", "prediction", "upper"))


def export_and_serve(cfg: dict, ckpt: str, inputs: str, tmp: str,
                     default: dict | None) -> None:
    """``scripts/export_serving.main`` on ``ckpt`` under ``cfg``, traced on
    the card and stored on the CPU (export), then ``infer.main --artifact``
    on ``inputs`` (artifact_serve): no port kernel launched, the intervals
    those of ``infer.main --config --checkpoint`` under the "xla" backends,
    bit for bit or within ARTIFACT_RTOL / ATOL, and those of ``default``
    (the live default config's, when given) within phase 7's bars. Each
    serving path runs twice, the first time warming it up."""
    dtype = cfg.get("compute_dtype", "float32")
    art = os.path.join(tmp, f"model_{dtype}.uq.pt2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, meta = _last_json(export_serving.main, [
        "--config", _write_config(tmp, f"export_{dtype}", cfg), "--checkpoint", ckpt,
        "--output", art, "--batch-size", str(cfg["batch_size"]), "--height", str(IMAGE),
        "--width", str(IMAGE), "--device", DEVICE])
    export_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"export_serving.main returned {rc}")
    stored = torch.export.load(art)
    tensors = [t for t in [*stored.state_dict.values(), *stored.constants.values()]
               if isinstance(t, torch.Tensor)]
    devices = sorted({t.device.type for t in tensors})
    node_devices = sorted({str(n.kwargs["device"]) for n in stored.graph.nodes
                           if isinstance(n.kwargs.get("device"), torch.device)})
    emit("export", compute_dtype=dtype, seconds=export_s, artifact_mb=meta["artifact_mb"],
         tensor_mb=sum(t.numel() * t.element_size() for t in tensors) / 1e6,
         tensors=len(tensors), param_count=meta["param_count"], platforms=meta["platforms"],
         program=meta["program"], lam=meta["lam"], tensor_devices=devices,
         graph_devices=node_devices, torch_version=meta["torch_version"])
    if devices != ["cpu"] or any(d != "cpu" for d in node_devices):
        raise AssertionError(f"the artifact is not stored on the CPU: {devices} {node_devices}")
    if meta["program"] != "portable_xla" or meta["platforms"] != ["cpu", "cuda"]:
        raise AssertionError(f"unexpected artifact metadata {meta}")
    del stored, tensors

    portable = _write_config(tmp, f"portable_{dtype}", dict(cfg, **XLA_BACKENDS))
    runs: dict = {"artifact": [], "live": []}
    for _ in range(2):
        for kind, args in (("artifact", ["--artifact", art]),
                           ("live", ["--config", portable, "--checkpoint", ckpt,
                                     "--batch-size", str(cfg["batch_size"])])):
            runs[kind].append(_serve_cli(args + ["--input", inputs],
                                         os.path.join(tmp, f"{kind}_{dtype}")))
    (art_out, art_summary, _), (live_out, _, _) = runs["artifact"][-1], runs["live"][-1]
    launched = {k: v for _, _, c in runs["artifact"] + runs["live"] for k, v in c.items() if v}
    same = all(np.array_equal(art_out[k], live_out[k]) for k in ("lower", "prediction", "upper"))
    diff = _max_abs(art_out, live_out)
    fields = {}
    if default is not None:
        fields["max_abs_diff_vs_default"] = _max_abs(art_out, default)
    emit("artifact_serve", compute_dtype=dtype, images=art_summary["images"],
         artifact_imgs_per_sec=[r[1]["imgs_per_sec"] for r in runs["artifact"]],
         live_portable_imgs_per_sec=[r[1]["imgs_per_sec"] for r in runs["live"]],
         bit_identical=same, max_abs_diff=diff, rtol=ARTIFACT_RTOL, atol=ARTIFACT_ATOL,
         lam=art_summary["lam"], cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, launched=launched, **fields)
    if launched:
        raise AssertionError(f"the portable paths launched port kernels: {launched}")
    if art_summary["lam"] != meta["lam"] or float(art_out["lam"]) != meta["lam"]:
        raise AssertionError(f"served λ {art_summary['lam']} != baked λ̂ {meta['lam']}")
    for k in ("lower", "prediction", "upper"):
        if art_out[k].shape != live_out[k].shape or not np.isfinite(art_out[k]).all():
            raise AssertionError(f"bad artifact {k}: shape {art_out[k].shape}")
        if not np.allclose(art_out[k], live_out[k], rtol=ARTIFACT_RTOL, atol=ARTIFACT_ATOL):
            raise AssertionError(f"the artifact's {k} is {diff} from the live portable model")
        if default is not None and not np.allclose(art_out[k], default[k], rtol=1e-4, atol=1e-5):
            raise AssertionError(f"the artifact's {k} is {fields['max_abs_diff_vs_default']} "
                                 "from the live default config")


def phase_deploy(config: dict, calib, serve) -> dict:
    """Phase 22: train once, recalibrate, export, serve from the artifact.
    The seed-0 weights of phase 5 go through the calibrate CLI under the
    default config and under ``pallas_fused`` (``calibrate_cli``), the
    default one's calibrated checkpoint through export and serving from
    the artifact in f32 and bf16 (``export_and_serve``), beside the live
    default config's serving in f32. → launches."""
    cfg = dict(config, num_examples=CALIB_N, image_size=IMAGE, seed=0, num_inputs=1)
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    weights = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    del st
    launches = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, counts = calibrate_cli("calibrate_cli", cfg, weights, calib, tmp, [])
        for name in KERNELS:
            launches[name] += counts[name]
        fused = dict(cfg, conv_backend="pallas_fused")
        _, counts = calibrate_cli("calibrate_cli_fused", fused, weights, calib, tmp,
                                  ["conv3x3", "conv3x3_bn_act"])
        for name in KERNELS:
            launches[name] += counts[name]

        inputs = os.path.join(tmp, "serve.npy")
        np.save(inputs, np.stack([serve[i][0] for i in range(len(serve))]))
        default, _, counts = _serve_cli(
            ["--config", _write_config(tmp, "default", cfg), "--checkpoint", ckpt,
             "--input", inputs, "--batch-size", str(cfg["batch_size"])],
            os.path.join(tmp, "default"))
        require_launches("deploy default serve", counts, ["upsample2x"])
        for name in KERNELS:
            launches[name] += counts[name]
        export_and_serve(cfg, ckpt, inputs, tmp, default)
        export_and_serve(dict(cfg, compute_dtype="bfloat16"), ckpt, inputs, tmp, None)
        interop_round_trip(cfg, ckpt, inputs, tmp, default)
    return launches


# the data_device phase: fastMRI singlecoil knee slices at full width
# (k-space 640x368, the reconstruction 320x320) under the router's default
# mask, then TEMCA at experiments/temca_test's patch side and downsampling
KSPACE_SHAPE, RECON = (640, 368), (320, 320)
MRI_MASK = {"type": "equispaced", "center_fraction": [0.08], "acceleration": [4]}
TEMCA_SIDE, TEMCA_DOWN, TEMCA_BATCH = 320, 4, 16
DATA_SEED = 17
# the card's reconstruction against the host transform (numpy's FFT): the
# JAX package's bar (tests/test_mri_pipeline.py)
RECON_RTOL, RECON_ATOL = 2e-4, 1e-5
# step 1's loss on the card's reconstruction against the image-mode step on
# the host's, relative (deterministic cuDNN on both): the inputs differ by
# the two FFTs' rounding alone
RAW_LOSS_RTOL = 1e-4
# the fastMRI router's volumes: slices each
ROUTER_VOLUMES, ROUTER_SLICES = 2, 24


class KspaceSlices:
    """fastMRI slices held in memory: each slice's masked k-space and its
    target, served as ``FastMRIDataset`` serves them, in image mode (the
    host ``UnetDataTransform``, then the dataset's normalisation) or, with
    ``return_kspace``, raw; the normalisation and ``device_preprocess`` are
    ``FastMRIDataset``'s own. The phase's stand-in for HDF5 volumes."""

    device_preprocess = FastMRIDataset.device_preprocess
    _apply_norm = FastMRIDataset._apply_norm

    def __init__(self, kspace: np.ndarray, targets: np.ndarray):
        self.kspace, self.targets = kspace, targets
        self.transform = UnetDataTransform("singlecoil")  # the mask is applied
        self.normalize_input, self.normalize_output = "standard", "min-max"
        self.norm_params = None
        self.return_kspace = False

    def __len__(self) -> int:
        return len(self.kspace)

    def host_image(self, i: int) -> np.ndarray:
        """The host transform's reconstruction of slice ``i``, unnormalised."""
        return self.transform(self.kspace[i], None, self.targets[i], {}, "slice.h5", i)[0]

    def __getitem__(self, i: int):
        target = self._apply_norm(self.targets[i], self.normalize_output, "output")
        target = np.asarray(target, np.float32)[..., None]
        if self.return_kspace:
            return self.kspace[i], target
        image = self._apply_norm(self.host_image(i), self.normalize_input, "input")
        return np.asarray(image, np.float32)[..., None], target


def mri_slices(n: int, seed: int) -> KspaceSlices:
    """``n`` slices made from ``seed`` on the host: random images, their
    centered orthonormal k-space at KSPACE_SHAPE, a fresh mask each
    (MRI_MASK, the mask's generator seeded), the targets the images'
    center crops' magnitudes, as ``write_synthetic_volume`` makes them."""
    rng = np.random.RandomState(seed)
    images = rng.randn(n, *KSPACE_SHAPE).astype(np.float32)
    kspace = fft2c_np(to_real_pair(images.astype(np.complex64))).astype(np.float32)
    mask_func = create_mask_for_mask_type(MRI_MASK["type"], MRI_MASK["center_fraction"],
                                          MRI_MASK["acceleration"])
    mask_func.rng.seed(seed)
    masked = np.stack([apply_mask(k, mask_func)[0] for k in kspace]).astype(np.float32)
    h0, w0 = [(a - b) // 2 for a, b in zip(KSPACE_SHAPE, RECON)]
    targets = np.abs(images[:, h0:h0 + RECON[0], w0:w0 + RECON[1]])
    return KspaceSlices(masked, targets)


def _stack(ds, idx) -> tuple:
    """The items ``idx`` of ``ds`` as one batch, every example real."""
    items = [ds[i] for i in idx]
    return (np.stack([x for x, _ in items]), np.stack([y for _, y in items]),
            np.ones((len(items),), np.float32))


def _nbytes(batch: tuple) -> int:
    return sum(a.nbytes for a in batch)


def _from(init: dict, cfg: dict) -> UQState:
    """A model under ``cfg`` on the card with the weights ``init``."""
    st = add_uncertainty(build_trunk(cfg), cfg, device=DEVICE)
    st.model.load_state_dict(init)
    return st


def _first_loss(init: dict, cfg: dict, batch: tuple, **hooks) -> float:
    """Step 1's loss from ``init`` on ``batch``, under deterministic cuDNN."""
    st = _from(init, cfg)
    opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(st.model, head_loss_pe_fn(st.uncertainty_type), cfg, opt,
                                 **hooks)
    with deterministic_cudnn():
        return float(step(*train.put_batch(*batch, torch.device(DEVICE),
                                           raw_input=hooks.get("preprocess") is not None)))


def _recording(hook, seen: list):
    """``hook``, recording the shape and dtype of what it is given."""
    def recorded(*xs):
        seen.append([[list(x.shape), str(x.dtype)] for x in xs])
        return hook(*xs)
    return recorded


def _mri_router(config: dict, tmp: str, smi: str) -> dict:
    """The router with ``on_device_transform: true`` on ROUTER_VOLUMES
    synthetic HDF5 volumes at full geometry (``write_synthetic_volume``)
    → launches. Training must reach the hook with raw k-space."""
    from im2im_uq_tpu_torch.data.fastmri import write_synthetic_volume

    data = os.path.join(tmp, "volumes")
    os.makedirs(data)
    for i in range(ROUTER_VOLUMES):
        write_synthetic_volume(os.path.join(data, f"vol{i}.h5"), num_slices=ROUTER_SLICES,
                               enc_shape=KSPACE_SHAPE, recon_shape=RECON, seed=DATA_SEED + i)
    with open(ROUTER_CONFIG.parent.parent / "fastmri_test" / "config.yml") as fh:
        sweep = yaml.safe_load(fh)
    for key, value in dict(uncertainty_type="quantiles", lr=config["lr"], epochs=1,
                           batch_size=config["batch_size"], load_from_checkpoint=False,
                           on_device_transform=True, validate_every=1,
                           num_validation_images=2, mask_info=MRI_MASK,
                           output_dir=os.path.join(tmp, "out"),
                           checkpoint_dir=os.path.join(tmp, "ckpt")).items():
        sweep["parameters"][key] = {"value": value}
    cfg_path = _write_config(tmp, "fastmri", sweep)
    (cfg,) = router.load_config(cfg_path)
    seen: list = []
    train_net = router.train_net

    def spy(*args, preprocess=None, **kw):
        return train_net(*args, preprocess=_recording(preprocess, seen), **kw)

    router.train_net = spy
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = router.main(["--config", cfg_path, "--data-path", data, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        router.train_net = train_net
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"router.main returned {rc}")
    with open(router.results_filename(cfg), "rb") as fh:
        results = pickle.load(fh)
    if sorted(results) != RESULT_KEYS or results["lhat"] not in lambda_grid(cfg):
        raise AssertionError(f"data_device_router: bad results {sorted(results)}")
    if not seen or any(b[0][0][1:] != [*KSPACE_SHAPE, 2] for b in seen):
        raise AssertionError(f"data_device_router: the hook saw {seen}, not raw k-space")
    require_launches("data_device_router", counts, DEFAULT_PATH_KERNELS)
    emit("data_device_router", h5py=True, volumes=ROUTER_VOLUMES, slices=ROUTER_SLICES,
         hook_inputs=seen, seconds=wall, lhat=float(results["lhat"]),
         risk=float(results["risk"]), card=smi, launches=_nonzero(counts))
    return counts


def _mri_train_net(config: dict, ds: KspaceSlices, smi: str) -> dict:
    """Without h5py: ``train_net`` with the hook on the in-memory slices,
    raw (its first 32 to train, the next 32 to validate) → launches."""
    cfg = dict(config, epochs=1)
    bs = cfg["batch_size"]
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(7), device=DEVICE)
    seen: list = []
    log = RecordLog()
    ds.return_kspace = True
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.train_net(st, Subset(ds, range(bs)), Subset(ds, range(bs, 2 * bs)), None, epochs=1,
                    batch_size=bs, lr=cfg["lr"], validate_every=1, config=cfg, logger=log,
                    preprocess=_recording(ds.device_preprocess(RECON), seen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds.return_kspace = False
    counts = read_counts()
    epoch = {k: v for r in log.records for k, v in r.items()}
    if not np.isfinite([epoch["train_loss"], epoch["val_loss"]]).all():
        raise AssertionError(f"data_device_train_net: losses not finite: {epoch}")
    if not seen or any(b[0][0] != [bs, *KSPACE_SHAPE, 2] for b in seen):
        raise AssertionError(f"data_device_train_net: the hook saw {seen}, not raw k-space")
    require_launches("data_device_train_net", counts,
                     ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"])
    emit("data_device_train_net", h5py=False, note="h5py is not installed: no HDF5 volumes, "
         "so train_net with the hook on in-memory slices in place of the router",
         hook_inputs=seen, seconds=wall, train_loss=epoch["train_loss"],
         val_loss=epoch["val_loss"], card=smi, launches=_nonzero(counts))
    return counts


def _has(module: str) -> bool:
    try:
        __import__(module)
    except ImportError:
        return False
    return True


def _data_device_mri(config: dict, smi: str) -> dict:
    """The fastMRI half of phase 23 → launches."""
    bs = config["batch_size"]
    t0 = time.perf_counter()
    ds = normalize_dataset(mri_slices(bs + CALIB_N, DATA_SEED))
    data_s = time.perf_counter() - t0
    train_idx = range(bs)
    ds.return_kspace = True
    raw = _stack(ds, train_idx)
    ds.return_kspace = False
    image = _stack(ds, train_idx)
    if raw[0].shape != (bs, *KSPACE_SHAPE, 2) or raw[0].dtype != np.float32:
        raise AssertionError(f"raw items {raw[0].shape} {raw[0].dtype}, not (B, 640, 368, 2)")

    # the card's reconstruction against the host transform, then the
    # closure (reconstruction and normalisation) against the image items
    k = torch.from_numpy(raw[0]).to(DEVICE)
    recon = zero_filled_recon(k, None, RECON).cpu().numpy()[:, 0]
    host = np.stack([ds.host_image(i) for i in train_idx])
    recon_err = float(np.abs(recon - host).max())
    pre = ds.device_preprocess(RECON)
    x = pre(k)
    closure_err = float(np.abs(x.cpu().numpy() - image[0].transpose(0, 3, 1, 2)).max())
    for got, want in ((recon, host), (x.cpu().numpy(), image[0].transpose(0, 3, 1, 2))):
        if not np.allclose(got, want, rtol=RECON_RTOL, atol=RECON_ATOL):
            raise AssertionError(f"data_device_fastmri: the card's reconstruction is off the "
                                 f"host's: {recon_err}, {closure_err}")
    pre_ms = time_ms(lambda: pre(k), 20)
    del k, x

    cfg = dict(config)
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    init = {n: v.detach().clone() for n, v in st.model.state_dict().items()}
    del st
    loss_raw = _first_loss(init, cfg, raw, preprocess=pre)
    loss_image = _first_loss(init, cfg, image)
    loss_err = abs(loss_raw - loss_image) / abs(loss_image)
    path = ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"]
    counts, losses, raw_ms = train_steps("data_device_fastmri", _from(init, cfg), cfg, raw, path,
                                         preprocess=pre)
    _, _, image_ms = train_steps("data_device_fastmri image mode", _from(init, cfg), cfg, image,
                                 path)
    emit("data_device_fastmri", kspace=list(KSPACE_SHAPE), recon=list(RECON), batch=bs,
         mask=MRI_MASK, raw_item_shape=list(raw[0].shape), raw_item_dtype=str(raw[0].dtype),
         data_seconds=data_s, recon_max_abs_err=recon_err, closure_max_abs_err=closure_err,
         recon_rtol=RECON_RTOL, recon_atol=RECON_ATOL, preprocess_ms=pre_ms,
         h2d_bytes_raw=_nbytes(raw), h2d_bytes_image=_nbytes(image),
         median_step_ms_raw=float(np.median(raw_ms)),
         median_step_ms_image=float(np.median(image_ms)), step_ms_raw=raw_ms,
         step_ms_image=image_ms, step1_loss_raw=loss_raw, step1_loss_image=loss_image,
         step1_loss_rel_err=loss_err, step1_loss_rtol=RAW_LOSS_RTOL, step_losses=losses,
         card=smi, launches=_nonzero(counts))
    if loss_err > RAW_LOSS_RTOL:
        raise AssertionError(f"data_device_fastmri: step 1's loss is {loss_err} off the "
                             "image-mode step's")
    launches = dict(counts)

    fused = dict(cfg, conv_backend="pallas_fused")
    counts, losses, fused_ms = train_steps("data_device_fastmri_fused", _from(init, fused),
                                           fused, raw, path + CONV_KERNELS, preprocess=pre)
    emit("data_device_fastmri_fused", conv_backend="pallas_fused", batch=bs,
         median_step_ms_raw=float(np.median(fused_ms)), step_ms_raw=fused_ms,
         step_losses=losses, card=smi, launches=_nonzero(counts))
    for name in KERNELS:
        launches[name] += counts[name]

    # calibration in image mode on CALIB_N slices
    st = _from(init, cfg)
    calib = Subset(ds, range(bs, bs + CALIB_N))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, table = calibrate_model(st, calib, cfg)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    counts = read_counts()
    if table.shape != (CALIB_N, cfg["num_lambdas"]) or not np.isfinite(table).all():
        raise AssertionError(f"data_device_calibrate: bad table {table.shape}")
    require_launches("data_device_calibrate", counts, ["loss_table", "upsample2x"])
    emit("data_device_calibrate", images=CALIB_N, image_mode=True, lhat=st.lhat,
         seconds=calib_s, card=smi, launches=_nonzero(counts))
    for name in KERNELS:
        launches[name] += counts[name]
    del st

    if _has("h5py"):
        with tempfile.TemporaryDirectory() as tmp:
            counts = _mri_router(cfg, tmp, smi)
    else:
        counts = _mri_train_net(cfg, ds, smi)
    for name in KERNELS:
        launches[name] += counts[name]
    return launches


def _data_device_temca(config: dict, smi: str) -> dict:
    """The TEMCA half of phase 23 → launches."""
    rng = np.random.RandomState(DATA_SEED)
    patches = rng.randint(0, 256, (TEMCA_BATCH, TEMCA_SIDE, TEMCA_SIDE), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        # no tiles: the patch buffer is filled here
        ds = TEMCADataset(tmp + "/", patch_size=(TEMCA_SIDE, TEMCA_SIDE),
                          downsampling=(TEMCA_DOWN, TEMCA_DOWN), buffer_size=1, normalize="01")
    items = {}
    for raw in (False, True):
        ds.reset()
        ds.patch_buffer = list(patches)
        ds.return_raw = raw
        items[raw] = list(ds)
    if len(items[True]) != TEMCA_BATCH or any(x is not y or x.dtype != np.uint8
                                              for x, y in items[True]):
        raise AssertionError("data_device_temca: the raw feed is not one uint8 patch an item")
    mask = np.ones((TEMCA_BATCH,), np.float32)
    raw = (np.stack([x for x, _ in items[True]]), np.stack([y for _, y in items[True]]), mask)
    image = (np.stack([x for x, _ in items[False]]), np.stack([y for _, y in items[False]]), mask)
    pair = ds.device_preprocess_pair()
    xr, yr, _ = train.put_batch(*raw, torch.device(DEVICE))
    low, gt = pair(xr, yr)
    same = (torch.equal(low.cpu(), nchw_from_nhwc(image[0], "cpu"))
            and torch.equal(gt.cpu(), nchw_from_nhwc(image[1], "cpu")))
    pair_ms = time_ms(lambda: pair(xr, yr), 20)
    del xr, yr, low, gt

    cfg = dict(config, batch_size=TEMCA_BATCH)
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(6), device=DEVICE)
    init = {n: v.detach().clone() for n, v in st.model.state_dict().items()}
    del st
    loss_raw = _first_loss(init, cfg, raw, preprocess_pair=pair)
    loss_image = _first_loss(init, cfg, image)
    path = ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"]
    counts, losses, raw_ms = train_steps("data_device_temca", _from(init, cfg), cfg, raw, path,
                                         preprocess_pair=pair)
    _, _, image_ms = train_steps("data_device_temca image mode", _from(init, cfg), cfg, image,
                                 path)
    emit("data_device_temca", side_length=TEMCA_SIDE, downsampling_factor=TEMCA_DOWN,
         batch=TEMCA_BATCH, raw_item_shape=list(raw[0].shape[1:]),
         raw_item_dtype=str(raw[0].dtype), pair_bit_identical=same, preprocess_ms=pair_ms,
         h2d_bytes_raw=_nbytes(raw), h2d_bytes_image=_nbytes(image),
         median_step_ms_raw=float(np.median(raw_ms)),
         median_step_ms_image=float(np.median(image_ms)), step_ms_raw=raw_ms,
         step_ms_image=image_ms, step1_loss_raw=loss_raw, step1_loss_image=loss_image,
         step_losses=losses, card=smi, launches=_nonzero(counts))
    if not same:
        raise AssertionError("data_device_temca: the card's pair is not the host's bit for bit")
    if loss_raw != loss_image:
        raise AssertionError(f"data_device_temca: step 1's loss {loss_raw} on the raw feed is "
                             f"not the image-mode step's {loss_image}")
    return counts


def phase_data_device(config: dict, smi: str) -> dict:
    """Phase 23: the on-device input transforms (module docstring) →
    launches."""
    t0 = time.perf_counter()
    launches = _data_device_mri(config, smi)
    counts = _data_device_temca(config, smi)
    for name in KERNELS:
        launches[name] += counts[name]
    emit("data_device", seconds=time.perf_counter() - t0, h5py=_has("h5py"),
         imageio=_has("imageio"), card=smi, launches=_nonzero(launches))
    return launches


# the dp phase: its train step cases (config overrides), SGD's rate
# (tests/test_parallel.py's), the DP steps timed one by one after the
# compared one (their median and spread are printed)
DP_CASES = {"xla": {}, "pallas_fused": {"conv_backend": "pallas_fused"},
            "pallas_fused_bf16": {"conv_backend": "pallas_fused", "compute_dtype": "bfloat16"}}
DP_LR, DP_TIMED_STEPS = 1e-2, 10
# the height-sharded serving of the dp phase: tiles of 648x640 (648 rows are
# no multiple of 16: the last rank takes 8 more, and Up pads), λ, its cases
# (config overrides), the bar on f32 (dp_serve's) and the bf16 rule: no
# farther from the one-process f32 intervals than SPATIAL_BF16_FACTOR times
# the one-process bf16 intervals are
SPATIAL_TILES, SPATIAL_H, SPATIAL_W, SPATIAL_LAM = 2, 648, 640, 1.5
SPATIAL_CASES = {
    "xla": {"conv_backend": "xla"},
    "xla_bf16": {"conv_backend": "xla", "compute_dtype": "bfloat16"},
    "pallas_fused": {"conv_backend": "pallas_fused"},
    "pallas_fused_bf16": {"conv_backend": "pallas_fused", "compute_dtype": "bfloat16"},
    "pallas_fused_resize_pallas": {"conv_backend": "pallas_fused", "resize_backend": "pallas"},
}
SPATIAL_ATOL, SPATIAL_BF16_FACTOR = 1e-4, 1.5
# the multi-seed path: seeds a rank, Adam's rate, its config overrides
MULTISEED_PER_RANK, MULTISEED_LR = 2, 1e-3
MULTISEED_CASE = {"conv_backend": "pallas_fused"}
# the CPU tests' bars on the parameters after one SGD step and the running
# statistics (tests/test_torch_port_parallel.py), required of the f32 cases
DP_CPU_RTOL, DP_CPU_ATOL = 1e-4, 2e-6
# the loss tables over the mesh against one process's: below one pixel's
# share of one image's loss (1 / 320² = 9.8e-6), so a row dropped,
# duplicated or out of order fails
DP_TABLE_ATOL = 1e-6
# how long the ranks may take, and a collective may wait, in seconds
DP_TIMEOUT_S, DP_COLLECTIVE_S = 400, 300
# the replays of MULTISTEP_N mesh steps timed in the dp phase's multistep
DP_TIMED_REPLAYS = 3
# the kernels each rank's DP step must launch under pallas_fused, beside
# K1f, K1b and K7
DP_FUSED_KERNELS = {"pallas_fused": ["conv3x3", "conv3x3_bn_act", "wgrad3x3", "dgrad3x3"],
                    "pallas_fused_bf16": BF16_TRAIN_KERNELS["pallas_fused"]}


class _Pairs:
    """(x, y) items of NHWC arrays, a map-style dataset."""

    def __init__(self, xs: np.ndarray, ys: np.ndarray):
        self.xs, self.ys = xs, ys

    def __len__(self) -> int:
        return len(self.xs)

    def __getitem__(self, i: int):
        return self.xs[i], self.ys[i]


# the midepoch phase: input_pipeline grain, 8 steps an epoch at batch 32, a
# mid-epoch checkpoint every 3 steps, SIGTERM while step 5's batch is read
MIDEPOCH_N, MIDEPOCH_EPOCHS, MIDEPOCH_EVERY, MIDEPOCH_STOP = 256, 2, 3, 5
# the multistep phase: steps a graph replay runs, the configs, and the eager
# and graph steps timed (CUDA events)
MULTISTEP_N = 10
# profiler sessions a count is the most of, and the small kernels that pad
# each session's ends (chip_smoke._profiled)
MULTISTEP_SESSIONS, PROFILE_PAD = 2, 64
MULTISTEP_CONFIGS = [
    ("f32_pallas_fused", {"conv_backend": "pallas_fused"}),
    ("bf16_pallas_fused", {"conv_backend": "pallas_fused", "compute_dtype": "bfloat16"}),
    ("f32_xla_pool_pallas", {"conv_backend": "xla", "pool_backend": "pallas"}),
]
MULTISTEP_PORT_BUCKETS = {
    "f32_pallas_fused": ["K1f upsample (port)", "K1b upsample backward (port)",
                         "K3/K4 conv3x3 (port)", "K5 wgrad3x3 (port)", "K6 dgrad3x3 (port)",
                         "K7 max-pool backward (port)"],
    "bf16_pallas_fused": ["K1f upsample (port)", "K1b upsample backward (port)",
                          "K3/K4 conv3x3 (port)", "K5 wgrad3x3 (port)", "K6 dgrad3x3 (port)",
                          "K7 max-pool backward (port)", "bf16 packing (port)"],
    "f32_xla_pool_pallas": ["K1f upsample (port)", "K1b upsample backward (port)",
                            "K7 max-pool backward (port)"],
}
# the resnet phase: ResNet18 + quantile head at 32x32, batch 32
RESNET_IMAGE, RESNET_STEPS, RESNET_CALIB_N = 32, 5, 256


class _SignalOnRead:
    """A dataset that sends SIGTERM to this process when one example is read
    (tests/test_graceful_shutdown.py's preemption)."""

    def __init__(self, dataset, index: int):
        self.dataset, self.index, self.sent = dataset, index, False

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        if i == self.index and not self.sent:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return self.dataset[i]


def _state_and_adam(st: UQState, ckpt_dir: str, cfg: dict) -> tuple[dict, dict]:
    """The model's state dict, and Adam's state from the run's final epoch
    checkpoint."""
    sd = {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}
    adam = torch.load(checkpoint_path(ckpt_dir, MIDEPOCH_EPOCHS, cfg), map_location="cpu",
                      weights_only=True)["optimizer"]["state"]
    return sd, adam


def phase_midepoch(config: dict, smi: str) -> dict:
    """``input_pipeline: grain`` with mid-epoch checkpoints at full width
    (``pallas_fused`` f32, deterministic cuDNN): run A uninterrupted; run B
    stopped by SIGTERM after step MIDEPOCH_STOP of epoch 0 and resumed from
    its mid-epoch checkpoint; the two bit for bit in weights, BatchNorm
    statistics, Adam's state and both epochs' losses. → launches."""
    cfg = dict(config, conv_backend="pallas_fused", input_pipeline="grain",
               checkpoint_every_steps=MIDEPOCH_EVERY, graceful_shutdown=True,
               epochs=MIDEPOCH_EPOCHS)
    bs = cfg["batch_size"]
    steps = MIDEPOCH_EPOCHS * MIDEPOCH_N // bs
    data = synthetic(MIDEPOCH_N, IMAGE, seed=21)
    val = synthetic(bs, IMAGE, seed=22)
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(21), device=DEVICE)
    init = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    # the first example of step MIDEPOCH_STOP's batch (epoch 0's seed is 1)
    index = int(make_grain_dataset(data, bs, shuffle=True, seed=1).indices(MIDEPOCH_STOP - 1)[0])

    def run(ckpt_dir: str, dataset, **kw) -> tuple[RecordLog, dict, float]:
        st.model.load_state_dict(init)
        log = RecordLog()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            train.train_net(st, dataset, val, None, epochs=MIDEPOCH_EPOCHS, batch_size=bs,
                            lr=cfg["lr"], checkpoint_dir=ckpt_dir,
                            checkpoint_every=MIDEPOCH_EPOCHS, validate_every=10, config=cfg,
                            logger=log, **kw)
        finally:
            torch.cuda.synchronize()
        return log, read_counts(), time.perf_counter() - t0

    losses = lambda log: [r["train_loss"] for r in log.records if "train_loss" in r]
    with deterministic_cudnn(), tempfile.TemporaryDirectory() as tmp:
        a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        log_a, counts, a_s = run(a_dir, data)
        # K1b 3 a step; K1f 3 a step and 3 for epoch 0's validation batch
        if (counts["upsample2x"], counts["upsample2x_bwd"]) != (K1_PER_STEP * (steps + 1),
                                                               K1_PER_STEP * steps):
            raise AssertionError(f"midepoch: K1f/K1b launched {counts['upsample2x']}, "
                                 f"{counts['upsample2x_bwd']} times in {steps} steps")
        for name in ("wgrad3x3", "dgrad3x3"):
            if counts[name] <= 0 or counts[name] % steps:
                raise AssertionError(f"midepoch: {name} launched {counts[name]} times in "
                                     f"{steps} steps")
        require_launches("midepoch", counts, ["conv3x3", "conv3x3_bn_act", "maxpool2x2_bwd"])
        want = _state_and_adam(st, a_dir, cfg)
        t0 = time.perf_counter()
        try:
            run(b_dir, _SignalOnRead(data, index))
            raise AssertionError("midepoch: the run was not stopped by SIGTERM")
        except train.PreemptionInterrupt as exc:
            stop_s = time.perf_counter() - t0
            mp = exc.checkpoint_path
        payload = torch.load(mp, map_location="cpu", weights_only=True)
        saved = {"epoch": payload["epoch"], "data_state": json.loads(payload["data_state"]),
                 "progress": json.loads(payload["progress"])}
        if saved["data_state"] != {"next_index": MIDEPOCH_STOP} or saved["epoch"] != 0:
            raise AssertionError(f"midepoch: the stop saved {saved}")
        file_mb = os.path.getsize(mp) / 1e6
        del payload
        log_b, counts_b, b_s = run(b_dir, data, load_from_checkpoint=True)
        got = _state_and_adam(st, b_dir, cfg)
        if os.path.exists(mp):
            raise AssertionError("midepoch: the mid-epoch file outlived its epoch")
        # one save alone, of run B's final model and Adam state
        opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
        opt.load_state_dict(torch.load(checkpoint_path(b_dir, MIDEPOCH_EPOCHS, cfg),
                                       weights_only=True)["optimizer"])
        t0 = time.perf_counter()
        save_midepoch_checkpoint(os.path.join(tmp, "timed.pt"), st.model, opt, None, 1,
                                 {"next_index": 3}, saved["progress"])
        save_s = time.perf_counter() - t0
    differ = [k for k in want[0] if not torch.equal(want[0][k], got[0][k])]
    differ += [f"adam.{i}.{n}" for i in want[1] for n, v in want[1][i].items()
               if not torch.equal(v, got[1][i][n])]
    same_losses = losses(log_a) == losses(log_b) and len(losses(log_a)) == MIDEPOCH_EPOCHS
    emit("midepoch", images=MIDEPOCH_N, batch=bs, epochs=MIDEPOCH_EPOCHS, steps=steps,
         checkpoint_every_steps=MIDEPOCH_EVERY, stopped_after_step=MIDEPOCH_STOP,
         saved=saved, uninterrupted_s=a_s, stopped_s=stop_s, resumed_s=b_s,
         save_seconds=save_s, file_mb=file_mb, losses_a=losses(log_a), losses_b=losses(log_b),
         bit_identical=not differ and same_losses, differ=differ[:10],
         tensors=len(want[0]) + sum(len(v) for v in want[1].values()), card=smi,
         launches=_nonzero(counts))
    if differ or not same_losses:
        raise AssertionError(f"midepoch: the resumed run differs: {differ[:10]} "
                             f"{losses(log_a)} {losses(log_b)}")
    return {k: counts[k] + counts_b[k] for k in KERNELS}


def _port_buckets(kernels: list) -> collections.Counter:
    """Launches per port-kernel bucket of ``profiling.bucket``."""
    return collections.Counter(b for b in (profiling.bucket(k[0]) for k in kernels)
                               if b.endswith("(port)"))


def _profiled(fn, *args, sessions: int = MULTISTEP_SESSIONS, device=DEVICE) -> tuple:
    """``fn(*args)`` once in each of ``sessions`` ``torch.profiler`` sessions
    → (the last result, the port's launches per bucket, the most of each
    over the sessions, and every session's). CUPTI drops a few kernel
    records at a session's ends (on the card: the first kernel or two of a
    session after an earlier one, or the last step of a replay), never adds
    one, so each session pads the call with PROFILE_PAD small kernels on
    ``device`` and a synchronized pause on both sides, and the most over
    the sessions is the count."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pad = torch.zeros(1, device=device)

    def padding():
        for _ in range(PROFILE_PAD):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)

    seen, out = [], None
    for _ in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            padding()
            out = fn(*args)
            torch.cuda.synchronize()
            padding()
        seen.append(_port_buckets(profiling.kernel_events(prof)))
    most = collections.Counter({b: max(c[b] for c in seen) for c in seen for b in c})
    return out, most, [dict(c) for c in seen]


def _train_state(model: torch.nn.Module, opt: torch.optim.Optimizer) -> dict:
    out = {f"model.{k}": v.detach().clone() for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"adam.{i}.{n}": v.detach().clone() for n, v in st.items()})
    return out


def _largest_diff(a: dict, b: dict) -> tuple[float, str]:
    worst = max(a, key=lambda k: (a[k].double() - b[k].double()).abs().max().item())
    return (a[worst].double() - b[worst].double()).abs().max().item(), worst


def phase_multistep(config: dict, smi: str) -> dict:
    """``make_train_multistep`` (MULTISTEP_N steps as one CUDA graph) at full
    width in each MULTISTEP_CONFIGS config, deterministic cuDNN: the replay's
    final state and last loss against MULTISTEP_N eager steps of the same
    capturable step from the same start, the launches of each port kernel
    in one replay (``torch.profiler``, the most over MULTISTEP_SESSIONS
    sessions: ``_profiled``) against MULTISTEP_N × one eager step's, ms a
    step eager and replayed, the peak memory of the eager steps and of the
    capture with its first replay; and the default (not capturable) Adam's
    steps beside the capturable one's. → launches (the Python counters
    count the capture)."""
    batch = path_batch(config, seed=23)
    launches = {k: 0 for k in KERNELS}
    for tag, over in MULTISTEP_CONFIGS:
        cfg = dict(config, **over)
        st = add_uncertainty(build_trunk(cfg), cfg,
                             generator=torch.Generator(device=DEVICE).manual_seed(23),
                             device=DEVICE)
        init = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        loss_fn = head_loss_pe_fn(st.uncertainty_type)
        tensors = train.put_batch(*batch, torch.device(DEVICE))
        with deterministic_cudnn():
            # the graph: capture and first replay, then the replay profiled
            # and timed
            opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"], capturable=True)
            multistep = train.make_train_multistep(st.model, loss_fn, cfg, opt, MULTISTEP_N)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            graph_loss = multistep(*tensors)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            counts = read_counts()
            graph_state = _train_state(st.model, opt)
            _, graph_counts, graph_sessions = _profiled(multistep, *tensors)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            events[0].record()
            for e in events[1:]:
                multistep(*tensors)
                e.record()
            events[-1].synchronize()
            graph_ms = [a.elapsed_time(b) / MULTISTEP_N for a, b in zip(events, events[1:])]
            del multistep, opt
            gc.collect()
            torch.cuda.empty_cache()

            # MULTISTEP_N eager steps of the same capturable step from init,
            # the first ones profiled, the rest timed
            st.model.load_state_dict(init)
            opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"], capturable=True)
            step = train.make_train_step(st.model, loss_fn, cfg, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, eager_counts, eager_sessions = _profiled(step, *tensors)
            losses, eager_ms = timed_steps(step, tensors, MULTISTEP_N - MULTISTEP_SESSIONS)
            eager_loss = torch.tensor(losses[-1], dtype=torch.float32)
            eager_peak_mb = torch.cuda.max_memory_allocated() / 2**20
            eager_state = _train_state(st.model, opt)
            same = (set(graph_state) == set(eager_state)
                    and all(torch.equal(graph_state[k], eager_state[k]) for k in eager_state)
                    and torch.equal(graph_loss.cpu(), eager_loss))
            diff, worst = (0.0, "") if same else _largest_diff(graph_state, eager_state)

            # the default Adam (bias correction on the host) from init
            st.model.load_state_dict(init)
            default_opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
            default_step = train.make_train_step(st.model, loss_fn, cfg, default_opt)
            default_losses, default_ms = timed_steps(default_step, tensors, MULTISTEP_N)
            default_diff = max((p.detach().double() - eager_state[f"model.{n}"].double())
                               .abs().max().item() for n, p in st.model.named_parameters())
            default_loss_diff = abs(default_losses[-1] - losses[-1])
            del default_opt, default_step
        required = MULTISTEP_PORT_BUCKETS[tag]
        wrong = {b: (eager_counts[b], graph_counts[b]) for b in set(eager_counts) | set(graph_counts)
                 if graph_counts[b] != MULTISTEP_N * eager_counts[b]}
        missing = [b for b in required if eager_counts[b] <= 0]
        eager_med, graph_med = float(np.median(eager_ms)), float(np.median(graph_ms))
        emit("multistep", config=tag, steps=MULTISTEP_N, batch=cfg["batch_size"], image=IMAGE,
             eager_ms=_spread(eager_ms), graph_ms=_spread(graph_ms),
             dispatch_ms=eager_med - graph_med, default_adam_ms=_spread(default_ms),
             capturable_minus_default_ms=eager_med - float(np.median(default_ms)),
             capturable_vs_default_max_param_diff=default_diff,
             capturable_vs_default_last_loss_diff=default_loss_diff,
             bit_identical=same, max_abs_diff=diff, worst=worst,
             last_loss=float(graph_loss), capture_s=capture_s, peak_mib=peak_mb,
             eager_peak_mib=eager_peak_mb,
             eager_launches=dict(eager_counts), replay_launches=dict(graph_counts),
             eager_sessions=eager_sessions, replay_sessions=graph_sessions,
             captured_counts=_nonzero(counts), card=smi)
        if missing or wrong:
            raise AssertionError(f"multistep {tag}: kernels missing {missing}, replay launches "
                                 f"not {MULTISTEP_N}x eager: {wrong}")
        if not same:
            raise AssertionError(f"multistep {tag}: the replay is not eager's bit for bit: "
                                 f"{diff} at {worst}, last loss {float(graph_loss)} against "
                                 f"{float(eager_loss)}")
        for name in KERNELS:
            launches[name] += counts[name]
        del st, opt, step, tensors
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_resnet(config: dict, smi: str) -> dict:
    """ResNet18 + quantile head at RESNET_IMAGE², batch 32: RESNET_STEPS
    train steps (every first gradient finite and nonzero, no port kernel
    but K1's and K7's absence checked), then calibration on RESNET_CALIB_N
    images, which launches K2. → launches."""
    cfg = dict(config, model="ResNet18")
    bs = cfg["batch_size"]
    ds = synthetic(bs, RESNET_IMAGE, seed=24)
    calib = synthetic(RESNET_CALIB_N, RESNET_IMAGE, seed=25)
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(24), device=DEVICE)
    tensors = train.put_batch(np.stack([ds[i][0] for i in range(bs)]),
                              np.stack([ds[i][1] for i in range(bs)]),
                              np.ones((bs,), np.float32), torch.device(DEVICE))
    opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"])
    step = train.make_train_step(st.model, head_loss_pe_fn("quantiles"), cfg, opt)
    reset_counts()
    losses = [float(step(*tensors))]
    check_first_gradients("resnet", st.model)
    more, step_ms = timed_steps(step, tensors, RESNET_STEPS - 1)
    train_counts = read_counts()
    losses += more
    if not np.isfinite(losses).all():
        raise AssertionError(f"resnet: train losses not finite: {losses}")
    on_path = _nonzero(train_counts)
    if on_path:
        raise AssertionError(f"resnet: the trunk launched port kernels: {on_path}")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, table = calibrate_model(st, calib, cfg)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    counts = read_counts()
    require_launches("resnet calibrate", counts, ["loss_table"])
    if table.shape != (RESNET_CALIB_N, cfg["num_lambdas"]) or not np.isfinite(table).all():
        raise AssertionError(f"resnet: bad calibration table {table.shape}")
    out = st.forward(tensors[0][:2])
    if out.shape != (2, 3, 1, RESNET_IMAGE, RESNET_IMAGE) or not torch.isfinite(out).all():
        raise AssertionError(f"resnet: bad forward {tuple(out.shape)}")
    emit("resnet", batch=bs, image=RESNET_IMAGE, step_losses=losses,
         median_step_ms=float(np.median(step_ms)), calibration_images=RESNET_CALIB_N,
         calibration_s=calib_s, lhat=st.lhat, card=smi, launches=_nonzero(counts))
    return counts


def interop_round_trip(cfg: dict, ckpt: str, inputs: str, tmp: str, default: dict) -> None:
    """``scripts/export_torch.main`` on the calibrated checkpoint, then
    ``scripts/import_torch.main`` on its output (interop): the reference
    layout's keys are the model's and ``lhat``, the imported weights are
    the checkpoint's bit for bit (``num_batches_tracked`` 0, as the JAX
    export writes it), λ̂ is kept, and serving from the imported
    calibrated checkpoint gives ``default``'s intervals bit for bit."""
    cfg_path = _write_config(tmp, "interop", cfg)
    pth, out_dir = os.path.join(tmp, "reference.pth"), os.path.join(tmp, "imported")
    t0 = time.perf_counter()
    if export_torch.main(["--checkpoint", ckpt, "--config", cfg_path, "--output", pth,
                          "--device", DEVICE]) != 0:
        raise AssertionError("export_torch.main failed")
    export_s = time.perf_counter() - t0
    if import_torch.main(["--checkpoint", pth, "--config", cfg_path, "--output-dir", out_dir,
                          "--device", DEVICE]) != 0:
        raise AssertionError("import_torch.main failed")
    exported = torch.load(pth, weights_only=True)
    original = torch.load(ckpt, weights_only=True)
    imported = torch.load(calibrated_checkpoint_path(out_dir, cfg), weights_only=True)
    keys_match = set(exported) == set(original["state_dict"]) | {"lhat"}
    weights_equal = all(
        torch.equal(imported["state_dict"][k],
                    torch.zeros_like(v) if k.endswith("num_batches_tracked") else v)
        for k, v in original["state_dict"].items())
    served, _, _ = _serve_cli(
        ["--config", cfg_path, "--checkpoint", calibrated_checkpoint_path(out_dir, cfg),
         "--input", inputs, "--batch-size", str(cfg["batch_size"])],
        os.path.join(tmp, "interop_serve"))
    same = all(np.array_equal(served[k], default[k]) for k in ("lower", "prediction", "upper"))
    emit("interop", keys=len(exported), keys_match=keys_match, weights_equal=weights_equal,
         lhat=[original["lhat"], float(exported["lhat"]), imported["lhat"]],
         pth_mb=os.path.getsize(pth) / 1e6, export_s=export_s,
         seconds=time.perf_counter() - t0, intervals_equal=same,
         max_abs_diff=_max_abs(served, default))
    if not (keys_match and weights_equal and same) or imported["lhat"] != original["lhat"]:
        raise AssertionError("interop: the export/import round trip changed the model")


def _max_rel_diff(got: dict, want: dict) -> tuple[float, str]:
    """max |got − want| / max |want| over each tensor, the worst and its name."""
    errs = {k: float((got[k].double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-30))
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _within(got: dict, want: dict, rtol: float, atol: float) -> bool:
    return all(torch.allclose(got[k].double(), w.double(), rtol=rtol, atol=atol)
               for k, w in want.items())


def _dp_train_case(name: str, cfg: dict, weights: dict, batch: tuple, mesh) -> dict:
    """One SGD step of ``weights`` under ``cfg`` over ``mesh``, counted and
    then timed; on rank 0 against the one-process step on its card, and
    that step timed on the whole batch and on rank 0's shard alone (the DP
    step less the shard's step is what the collectives and the waits on
    the other rank cost)."""
    def one_step(m, shard=False):
        st = add_uncertainty(build_trunk(cfg), cfg, device=mesh.device)
        st.model.load_state_dict(weights)
        opt = torch.optim.SGD(st.model.parameters(), lr=DP_LR)
        step = train.make_train_step(st.model, head_loss_pe_fn(st.uncertainty_type), cfg, opt, m)
        rows = mesh_lib.put_batch(mesh if shard else m, *batch)
        tensors = train.put_batch(*rows, mesh.device)
        loss = float(step(*tensors))
        torch.cuda.synchronize()
        out = (loss, {n: p.grad.detach().clone() for n, p in st.model.named_parameters()},
               {n: p.detach().clone() for n, p in st.model.named_parameters()},
               {n: b.detach().clone() for n, b in st.model.named_buffers() if "running" in n})
        return out, step, tensors

    def time_steps(step, tensors, m) -> list:
        """ms of each of DP_TIMED_STEPS steps (CUDA events between them)."""
        if m is not None:
            m.barrier()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(DP_TIMED_STEPS + 1)]
        events[0].record()
        for ev in events[1:]:
            step(*tensors)
            ev.record()
        if m is not None:
            m.barrier()
        events[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    reset_counts()
    (loss, grads, params, stats), step, tensors = one_step(mesh)
    counts = read_counts()
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    if bad:
        raise AssertionError(f"dp_train {name}: gradients not finite or zero: {bad}")
    res = {"loss": loss, "launches": counts, "steps_ms": time_steps(step, tensors, mesh)}
    del step, tensors
    if mesh.is_main:
        (ref_loss, ref_grads, ref_params, ref_stats), step, tensors = one_step(None)
        res["steps_ms_one_process"] = time_steps(step, tensors, None)
        _, step, tensors = one_step(None, shard=True)
        res["steps_ms_shard_one_process"] = time_steps(step, tensors, None)
        del step, tensors
        grad_err = _rel_errors({k: v.double().cpu() for k, v in grads.items()},
                               {k: v.double().cpu() for k, v in ref_grads.items()})
        worst_g = max(grad_err, key=grad_err.get)
        res.update(
            loss_one_process=ref_loss, loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
            max_grad_err=grad_err[worst_g], worst_grad=worst_g,
            whole_grad_err=_rel_l2(torch.cat([grads[k].flatten() for k in ref_grads]),
                                   torch.cat([ref_grads[k].flatten() for k in ref_grads])),
            max_rel_param_diff=_max_rel_diff(params, ref_params),
            max_rel_stat_diff=_max_rel_diff(stats, ref_stats),
            max_stat_err=max(_rel_l2(stats[k], v) for k, v in ref_stats.items()),
            within_cpu_bars=_within({**params, **stats}, {**ref_params, **ref_stats},
                                    DP_CPU_RTOL, DP_CPU_ATOL))
    return res


def dp_worker(tmp: Path) -> int:
    """One rank of the dp phase (``--dp-worker DIR``): the train steps,
    calibration, serving, the data-parallel artifact, height-sharded
    serving and the multi-seed step over the mesh, results to
    DIR/dp_rank{r}.json."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = "nccl" if torch.cuda.device_count() >= int(os.environ["WORLD_SIZE"]) else "gloo"
    distributed.init_distributed(device="cuda", backend=backend,
                                 timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S))
    mesh = mesh_lib.data_parallel_mesh("cuda")
    config = dict(infer.DEFAULTS, **CONFIG)
    weights = torch.load(tmp / "weights.pt", map_location=mesh.device, weights_only=True)
    with np.load(tmp / "data.npz") as z:
        data = {k: z[k] for k in z.files}
    batch = (data["x"], data["y"], data["mask"])
    out = {"rank": mesh.rank, "backend": backend, "device": str(mesh.device), "train": {}}
    launches = {k: 0 for k in KERNELS}

    def count(counts):
        for k, v in counts.items():
            launches[k] += v

    for name, extra in DP_CASES.items():
        res = _dp_train_case(name, dict(config, **extra), weights, batch, mesh)
        count(res["launches"])
        out["train"][name] = res
        gc.collect()
        torch.cuda.empty_cache()

    cfg = dict(config, conv_backend="pallas_fused")
    calib = _Pairs(data["calib_x"], data["calib_y"])
    state = add_uncertainty(build_trunk(cfg), cfg, device=mesh.device,
                            generator=torch.Generator(device=mesh.device).manual_seed(0))
    mesh_lib.replicate_tree(mesh, state.model)
    grid = lambda_grid(cfg)
    shifted = grid - (grid[1] - grid[0])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal, table = calibrate_model(state, calib, cfg, mesh=mesh)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal_counts = read_counts()
    reset_counts()
    risks = compute_risks_device(state, calib, shifted, batch_size=cfg["batch_size"], mesh=mesh,
                                 method="pallas")
    torch.cuda.synchronize()
    risk_counts = read_counts()
    count(cal_counts)
    count(risk_counts)
    # for the comparison alone: the whole table over the mesh (calibrate_model
    # zeroes the columns below λ̂'s)
    raw = compute_loss_table(state, calib, shifted, batch_size=cfg["batch_size"], mesh=mesh,
                             method="pallas")
    res = {"lhat": cal.lhat, "seconds": cal_s, "launches": cal_counts,
           "risks_launches": risk_counts,
           "risks_vs_table": float(np.abs(risks - raw.mean(axis=0)).max())}
    if mesh.is_main:
        ref, ref_table = calibrate_model(state, calib, cfg)
        ref_raw = compute_loss_table(state, calib, shifted, batch_size=cfg["batch_size"],
                                     method="pallas")
        res.update(lhat_one_process=ref.lhat,
                   table_max_abs_diff=_table_diff(table, ref_table),
                   table_bit_identical=bool(np.array_equal(table, ref_table)),
                   whole_table_max_abs_diff=_table_diff(raw, ref_raw),
                   whole_table_bit_identical=bool(np.array_equal(raw, ref_raw)),
                   risks_vs_one_process=float(np.abs(risks - ref_raw.mean(axis=0)).max()))
        ckpt = save_calibrated_checkpoint(cal, cfg, str(tmp / "ckpt"))
        with open(tmp / "dp.yml", "w") as fh:
            yaml.safe_dump(cfg, fh)
        res["checkpoint"] = ckpt
    out["calibrate"] = res
    mesh.barrier()  # rank 0's checkpoint and config are written

    ckpt = calibrated_checkpoint_path(str(tmp / "ckpt"), cfg)
    reset_counts()
    rc = infer.main(["--config", str(tmp / "dp.yml"), "--checkpoint", ckpt, "--input",
                     str(tmp / "serve.npy"), "--output", str(tmp / "served"), "--batch-size",
                     str(cfg["batch_size"]), "--data-parallel", "--device", "cuda"])
    torch.cuda.synchronize()
    serve_counts = read_counts()
    count(serve_counts)
    res = {"rc": rc, "launches": serve_counts}
    mesh.barrier()  # rank 0's intervals are written
    if mesh.is_main:
        with np.load(tmp / "served" / "serve_intervals.npz") as z:
            served = {k: z[k] for k in z.files}
        with open(tmp / "served" / "inference_summary.json") as fh:
            res["summary"] = json.load(fh)
        want = infer.predict_intervals(cal, np.load(tmp / "serve.npy"), cfg["batch_size"])
        res["max_abs_diff"] = _max_abs(served, want)
        res["bit_identical"] = all(np.array_equal(served[k], want[k]) for k in want)
        res["lam"] = float(served["lam"])
    out["serve"] = res
    out["artifact"] = _dp_artifact(tmp, mesh)
    out["spatial"] = _dp_spatial(tmp, mesh)
    out["multiseed"] = _dp_multiseed(config, batch, mesh)
    count(out["multiseed"]["launches"])
    out["multistep"] = _dp_multistep(config, batch, mesh)
    count(out["multistep"]["launches"])
    for res in out["spatial"].values():
        count(res["launches"])
    out["launches"] = launches
    with open(tmp / f"dp_rank{mesh.rank}.json", "w") as fh:
        json.dump(out, fh)
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _same_on_every_rank(tensors: dict, mesh) -> bool:
    """Whether every rank holds rank 0's ``tensors`` bit for bit (each
    dtype's flattened into one and broadcast from rank 0)."""
    by_dtype: dict = {}
    for t in tensors.values():
        by_dtype.setdefault(t.dtype, []).append(t.detach().flatten())
    same = True
    for flat in (torch.cat(ts) for ts in by_dtype.values()):
        first = flat.clone()
        mesh.broadcast_(first)
        same &= bool(torch.equal(first, flat))
    return not mesh.agree(not same)


def _dp_multistep(config: dict, batch: tuple, mesh) -> dict:
    """dp_multistep: ``make_train_multistep`` over the mesh. Over NCCL, each
    MULTISTEP_CONFIGS config as ``phase_multistep`` runs it, with this
    rank's slice of the global batch and deterministic cuDNN: the replay's
    final state and last loss against MULTISTEP_N eager capturable mesh
    steps from the same start, whether every rank holds the same bits, the
    port's launches in one replay and in one eager step (``_profiled``), ms
    a step eager and replayed, peak memory (the capture with its first
    replay, and the eager steps). Over gloo (two ranks on one card) the
    call must raise the ValueError that names NCCL: no graph is captured.
    → results, with the capture's launches."""
    backend = torch.distributed.get_backend(mesh.group)
    out = {"backend": backend, "configs": {}, "launches": {k: 0 for k in KERNELS}}
    if backend != "nccl":
        cfg = dict(config, **MULTISTEP_CONFIGS[0][1])
        st = add_uncertainty(build_trunk(cfg), cfg, device=mesh.device)
        opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"], capturable=True)
        try:
            train.make_train_multistep(st.model, head_loss_pe_fn(st.uncertainty_type), cfg, opt,
                                       MULTISTEP_N, mesh)
            out["refusal"] = None
        except ValueError as exc:
            out["refusal"] = str(exc)
        return out
    tensors = train.put_batch(*mesh_lib.put_batch(mesh, *batch), mesh.device)
    for tag, over in MULTISTEP_CONFIGS:
        _release(mesh)
        cfg = dict(config, **over)
        st = add_uncertainty(build_trunk(cfg), cfg, device=mesh.device,
                             generator=torch.Generator(device=mesh.device).manual_seed(23))
        mesh_lib.replicate_tree(mesh, st.model)
        init = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
        loss_fn = head_loss_pe_fn(st.uncertainty_type)
        with deterministic_cudnn():
            opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"], capturable=True)
            multistep = train.make_train_multistep(st.model, loss_fn, cfg, opt, MULTISTEP_N,
                                                   mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            graph_loss = multistep(*tensors)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            peak_mib = torch.cuda.max_memory_allocated() / 2**20
            counts = read_counts()
            graph_state = _train_state(st.model, opt)
            graph_state["last_loss"] = graph_loss
            replicas_equal = _same_on_every_rank(graph_state, mesh)
            _, graph_counts, graph_sessions = _profiled(multistep, *tensors,
                                                        device=mesh.device)
            # the ranks start the timed replays together: a replay's first
            # collective waits for the last rank to arrive
            mesh.barrier()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(DP_TIMED_REPLAYS + 1)]
            events[0].record()
            for e in events[1:]:
                multistep(*tensors)
                e.record()
            events[-1].synchronize()
            graph_ms = [a.elapsed_time(b) / MULTISTEP_N for a, b in zip(events, events[1:])]
            del multistep, opt
            gc.collect()
            torch.cuda.empty_cache()

            st.model.load_state_dict(init)
            opt = torch.optim.Adam(st.model.parameters(), lr=cfg["lr"], capturable=True)
            step = train.make_train_step(st.model, loss_fn, cfg, opt, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, eager_counts, eager_sessions = _profiled(step, *tensors, device=mesh.device)
            mesh.barrier()
            losses, eager_ms = timed_steps(step, tensors, MULTISTEP_N - MULTISTEP_SESSIONS)
            eager_peak_mib = torch.cuda.max_memory_allocated() / 2**20
            eager_state = _train_state(st.model, opt)
            eager_state["last_loss"] = torch.tensor(losses[-1], dtype=torch.float32,
                                                    device=mesh.device)
            same = (set(graph_state) == set(eager_state)
                    and all(torch.equal(graph_state[k], eager_state[k]) for k in eager_state))
            diff, worst = (0.0, "") if same else _largest_diff(graph_state, eager_state)
        out["configs"][tag] = {
            "bit_identical": same, "max_abs_diff": diff, "worst": worst,
            "replicas_equal": replicas_equal, "last_loss": float(graph_loss),
            "eager_last_loss": losses[-1], "capture_s": capture_s, "peak_mib": peak_mib,
            "eager_peak_mib": eager_peak_mib, "graph_ms": graph_ms, "eager_ms": eager_ms,
            "eager_launches": dict(eager_counts), "replay_launches": dict(graph_counts),
            "eager_sessions": eager_sessions, "replay_sessions": graph_sessions,
            "captured_counts": _nonzero(counts),
        }
        for name in KERNELS:
            out["launches"][name] += counts[name]
        del st, opt, step
    del tensors
    _release(mesh)
    return out


def dp_ranks() -> int:
    """The dp phase's ranks: one a visible card, or two on one card."""
    return max(torch.cuda.device_count(), 2)


def _release(mesh) -> None:
    """Every rank's cached device memory given back before the next path
    starts on any rank (the ranks may share a card)."""
    gc.collect()
    torch.cuda.empty_cache()
    mesh.barrier()


def _dp_artifact(tmp: Path, mesh) -> dict:
    """``infer.main --artifact`` of the data-parallel artifact over the
    ranks, counted. Then each rank holds the rows it served to the
    one-process artifact exported at the per-rank batch, run in this
    process on the same images, and rank 0 the whole result to the
    one-process artifact at the global batch. cuDNN picks a conv's
    algorithm in each process, by the batch and by the memory free for its
    workspace (which ranks sharing a card take from each other), so only
    the first comparison runs the same algorithms on both sides; and only
    its deterministic algorithms give the same bits twice, so the path
    runs under ``deterministic_cudnn``, and from a released cache on every
    rank (a conv whose best algorithm finds no room for its workspace takes
    another)."""
    _release(mesh)
    res = {"free_gib": torch.cuda.mem_get_info(mesh.device)[0] / 2**30}
    reset_counts()
    t0 = time.perf_counter()
    with deterministic_cudnn():
        rc = infer.main(["--artifact", str(tmp / "art_dp.pt2"), "--input",
                         str(tmp / "serve.npy"), "--output", str(tmp / "served_art"),
                         "--device", mesh.device.type])
    torch.cuda.synchronize()
    res.update(rc=rc, launches=read_counts(), seconds=time.perf_counter() - t0)
    mesh.barrier()  # rank 0's intervals are written
    with np.load(tmp / "served_art" / "serve_intervals.npz") as z:
        served = {k: z[k] for k in z.files}
    images = np.load(tmp / "serve.npy")
    one = export_serving.load_serving_artifact(str(tmp / "art_one_rank.pt2"), mesh.device)
    k = one.batch_size  # this rank's share of each global batch of k · ranks images
    rows = np.arange(len(images)).reshape(-1, mesh.size, k)[:, mesh.rank].reshape(-1)
    with deterministic_cudnn():
        want = infer.predict_intervals(one, images[rows], k)
    res["own_rows"] = {"batch_size": k, "max_abs_diff": _max_abs(
        {n: served[n][rows] for n in want}, want), "bit_identical": all(
        np.array_equal(served[n][rows], want[n]) for n in want)}
    if mesh.is_main:
        one = export_serving.load_serving_artifact(str(tmp / "art_one.pt2"), mesh.device)
        with deterministic_cudnn():
            want = infer.predict_intervals(one, images, one.batch_size)
        res["one"] = {"batch_size": one.batch_size, "max_abs_diff": _max_abs(served, want),
                      "bit_identical": all(np.array_equal(served[n], want[n]) for n in want)}
        res.update(lam=float(served["lam"]), shape=list(served["lower"].shape))
    return res


def _spatial_state(tmp: Path, name: str, device, f32: bool = False) -> UQState:
    cfg = dict(infer.DEFAULTS, **CONFIG, **SPATIAL_CASES[name])
    if f32:
        cfg.pop("compute_dtype", None)
    return infer.load_uq_state_for_inference(cfg, str(tmp / "serve_ckpt.pt"), device)


def _dp_spatial(tmp: Path, mesh) -> dict:
    """``infer.main --spatial`` on the tiles under each SPATIAL_CASES
    config over the ranks, each counted; on rank 0 the one-process
    intervals of the same config (and in f32) on the same card, and the
    launches of that one-process run, which each rank's must equal but for
    K1f (each rank runs every layer once; the upsample takes K1f only under
    ``resize_backend: pallas``, over the gathered height)."""
    _release(mesh)
    tiles = np.load(tmp / "tiles.npy")
    out = {}
    for name in SPATIAL_CASES:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = infer.main(["--config", str(tmp / f"spatial_{name}.yml"), "--checkpoint",
                         str(tmp / "serve_ckpt.pt"), "--input", str(tmp / "tiles.npy"),
                         "--output", str(tmp / f"spatial_{name}"), "--spatial", "--device",
                         mesh.device.type])
        torch.cuda.synchronize()
        out[name] = {"rc": rc, "seconds": time.perf_counter() - t0, "launches": read_counts()}
    mesh.barrier()  # rank 0's intervals are written
    if not mesh.is_main:
        return out
    for name, extra in SPATIAL_CASES.items():
        with np.load(tmp / f"spatial_{name}" / "tiles_intervals.npz") as z:
            got = {k: z[k] for k in z.files}
        reset_counts()
        want = infer.predict_intervals(_spatial_state(tmp, name, mesh.device), tiles, 1,
                                       lam=SPATIAL_LAM)
        torch.cuda.synchronize()
        expected = read_counts()
        if extra.get("resize_backend") != "pallas":
            expected["upsample2x"] = 0
        res = out[name]
        res.update(expected_launches=expected, max_abs_diff=_max_abs(got, want),
                   bit_identical=all(np.array_equal(got[k], want[k]) for k in want),
                   shape=list(got["lower"].shape), lam=float(got["lam"]),
                   finite=all(bool(np.isfinite(got[k]).all()) for k in want))
        if "bf16" in name:
            f32 = infer.predict_intervals(_spatial_state(tmp, name, mesh.device, f32=True),
                                          tiles, 1, lam=SPATIAL_LAM)
            res.update(max_abs_diff_vs_f32=_max_abs(got, f32),
                       one_process_bf16_vs_f32=_max_abs(want, f32))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dp_multiseed(config: dict, batch: tuple, mesh) -> dict:
    """MULTISEED_PER_RANK seeds a rank through ``training/multiseed.py``
    (Adam, ``pallas_fused`` f32, one step on the phase's batch, which every
    replica sees whole), counted; then each local seed's one-process plain
    step on this card from the same seed, counted: the expected launches,
    and the reference. cuDNN deterministic on both."""
    _release(mesh)
    cfg = dict(config, **MULTISEED_CASE)
    st = UQState(model=None, params=cfg)
    opt = lambda p: torch.optim.Adam(p, lr=MULTISEED_LR)  # noqa: E731
    seeds = list(range(MULTISEED_PER_RANK * mesh.size))
    states = multiseed.shard_multiseed_state(
        multiseed.init_multiseed_states(st, seeds, opt, torch.zeros(1, device=mesh.device)), mesh)
    step = multiseed.make_multiseed_train_step(st, opt, mesh)
    tensors = train.put_batch(*batch, mesh.device)
    reset_counts()
    t0 = time.perf_counter()
    with deterministic_cudnn():
        _, losses = step(states, *tensors)
    torch.cuda.synchronize()
    res = {"seeds": list(states.local_seeds), "losses": losses.tolist(), "launches": read_counts(),
           "seconds": time.perf_counter() - t0}
    reset_counts()
    ref_losses, gaps, same = [], [], True
    for s, model in zip(states.local_seeds, states.models):
        ref = add_uncertainty(build_trunk(cfg), cfg, generator=torch.Generator().manual_seed(s),
                              device=mesh.device)
        ref_opt = torch.optim.Adam(ref.model.parameters(), lr=MULTISEED_LR)
        ref_step = train.make_train_step(ref.model, head_loss_pe_fn(cfg["uncertainty_type"]),
                                         cfg, ref_opt)
        with deterministic_cudnn():
            ref_losses.append(float(ref_step(*tensors)))
        got, want = model.state_dict(), ref.model.state_dict()
        gaps.append(max(float((got[k].double() - want[k].double()).abs().max()) for k in want))
        same &= all(torch.equal(got[k], want[k]) for k in want)
    torch.cuda.synchronize()
    res.update(expected_launches=read_counts(), losses_one_process=ref_losses,
               max_abs_param_diff=max(gaps),
               bit_identical=bool(same and res["losses"] == ref_losses))
    return res


def _table_diff(a: np.ndarray, b: np.ndarray) -> float:
    """max |a − b|, or inf where the tables' shapes differ."""
    return float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")


def _spawn_dp_ranks(tmp: Path, ranks: int) -> list[dict]:
    """The dp phase's ranks, this script with ``--dp-worker``, started by
    the port's ``spawn_per_device``; each rank's log goes to
    tmp/rank{r}.log. Every rank is killed if one fails or the phase
    outlasts DP_TIMEOUT_S."""
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(ranks)]
    try:
        rc = distributed.spawn_per_device(
            [str(Path(__file__).resolve()), "--dp-worker", str(tmp)], ranks,
            timeout=DP_TIMEOUT_S, stdout=logs)
    finally:
        for fh in logs:
            fh.close()
    if rc != 0:
        tails = "\n".join(f"--- rank {r}:\n" + (tmp / f"rank{r}.log").read_text()[-3000:]
                          for r in range(ranks))
        raise AssertionError(f"the dp ranks exited {rc}:\n{tails}")
    results = []
    for r in range(ranks):
        with open(tmp / f"dp_rank{r}.json") as fh:
            results.append(json.load(fh))
    return results


def _dp_inputs(tmp: Path, cfg: dict, weights: dict, n: int) -> dict:
    """What the ranks read beyond the weights and data: the phase's weights
    as a calibrated checkpoint (λ̂ = SPATIAL_LAM), the configs of the
    spatial cases, the tiles, and the serving artifact of ``cfg`` traced on
    the card (``export_serving.main``) for ``n`` devices, and for one at
    the global batch and at the per-rank batch → the exports' lines."""
    state = add_uncertainty(build_trunk(cfg), cfg, device=DEVICE)
    state.model.load_state_dict(weights)
    ckpt = save_calibrated_checkpoint(state.replace(lhat=SPATIAL_LAM), cfg, str(tmp / "ckpt_s"))
    os.replace(ckpt, tmp / "serve_ckpt.pt")
    del state
    for name, extra in SPATIAL_CASES.items():
        with open(tmp / f"spatial_{name}.yml", "w") as fh:
            yaml.safe_dump(dict(CONFIG, **extra), fh)
    tiles = np.random.RandomState(9).rand(SPATIAL_TILES, SPATIAL_H, SPATIAL_W, 1)
    np.save(tmp / "tiles.npy", tiles.astype(np.float32))
    exports = {}
    b = cfg["batch_size"]
    for tag, devices, batch in (("dp", n, b), ("one", 1, b), ("one_rank", 1, b // n)):
        t0 = time.perf_counter()
        rc, meta = _last_json(export_serving.main, [
            "--config", _write_config(str(tmp), "export", cfg), "--checkpoint",
            str(tmp / "serve_ckpt.pt"), "--output", str(tmp / f"art_{tag}.pt2"),
            "--batch-size", str(batch), "--height", str(IMAGE), "--width", str(IMAGE),
            "--n-devices", str(devices), "--device", DEVICE])
        if rc != 0 or meta["n_devices"] != devices:
            raise AssertionError(f"export_serving.main --n-devices {devices}: rc {rc}, {meta}")
        exports[tag] = {"seconds": time.perf_counter() - t0, "artifact_mb": meta["artifact_mb"],
                        "n_devices": devices, "batch_size": meta["batch_size"]}
    return exports


def _nonzero(counts: dict) -> dict:
    """The kernels a count saw launched, for the lines."""
    return {k: v for k, v in counts.items() if v}


def _spread(ms: list) -> dict:
    return {"median": float(np.median(ms)), "min": min(ms), "max": max(ms), "steps": len(ms)}


def _check_dp_artifact(ranks: list, exports: dict, smi: str) -> None:
    art = [r["artifact"] for r in ranks]
    emit("dp_artifact", ranks=len(ranks), exports=exports, images=SERVE_N,
         rc=[a["rc"] for a in art], vs_one_process=art[0]["one"],
         own_rows_vs_one_process_rank_batch=[a["own_rows"] for a in art],
         free_gib_per_rank=[a["free_gib"] for a in art], lam=art[0]["lam"],
         shape=art[0]["shape"],
         seconds=[a["seconds"] for a in art],
         launches_per_rank=[_nonzero(a["launches"]) for a in art], card=smi)
    if any(a["rc"] != 0 for a in art) or art[0]["lam"] != SPATIAL_LAM:
        raise AssertionError(f"dp_artifact: infer.main failed or served another λ: {art}")
    if art[0]["shape"] != [SERVE_N, IMAGE, IMAGE, 1] or art[0]["one"]["max_abs_diff"] > 1e-4:
        raise AssertionError(f"dp_artifact: the intervals are {art[0]['one']['max_abs_diff']} "
                             "from the one-process artifact's")
    bad = [r for r, a in enumerate(art) if not a["own_rows"]["bit_identical"]]
    if bad:
        raise AssertionError(f"dp_artifact: ranks {bad} served rows that differ from the "
                             "one-process artifact's at the per-rank batch in their process")
    launched = {k: v for a in art for k, v in a["launches"].items() if v}
    if launched:
        raise AssertionError(f"dp_artifact: the portable program launched port kernels: {launched}")


def _check_spatial(ranks: list, smi: str) -> dict:
    """The spatial lines and checks → the launches of every rank."""
    sums = collections.Counter()
    for name, extra in SPATIAL_CASES.items():
        per_rank = [r["spatial"][name] for r in ranks]
        res = per_rank[0]
        emit("spatial", case=name, ranks=len(ranks), tiles=SPATIAL_TILES,
             image=[SPATIAL_H, SPATIAL_W], rows_per_rank=[list(s) for s in
                                                          spatial.row_spans(SPATIAL_H, len(ranks))],
             card=smi, **{k: v for k, v in res.items()
                          if k not in ("launches", "rc", "seconds", "expected_launches")},
             rc=[p["rc"] for p in per_rank], seconds_per_rank=[p["seconds"] for p in per_rank],
             expected_launches=_nonzero(res["expected_launches"]),
             launches_per_rank=[_nonzero(p["launches"]) for p in per_rank])
        if any(p["rc"] != 0 for p in per_rank) or not res["finite"] or res["lam"] != SPATIAL_LAM:
            raise AssertionError(f"spatial {name}: infer.main failed or served bad intervals")
        if res["shape"] != [SPATIAL_TILES, SPATIAL_H, SPATIAL_W, 1]:
            raise AssertionError(f"spatial {name}: intervals of shape {res['shape']}")
        if "bf16" in name:
            if res["max_abs_diff_vs_f32"] > SPATIAL_BF16_FACTOR * res["one_process_bf16_vs_f32"]:
                raise AssertionError(f"spatial {name}: {res['max_abs_diff_vs_f32']} from the f32 "
                                     "intervals, past the bf16 rule")
        elif res["max_abs_diff"] > SPATIAL_ATOL:
            raise AssertionError(f"spatial {name}: {res['max_abs_diff']} from one process")
        kernels = [k for k, v in res["expected_launches"].items() if v]
        if extra["conv_backend"] != "xla" and not kernels:
            raise AssertionError(f"spatial {name}: the one-process run launched no kernel")
        for r, p in enumerate(per_rank):
            if p["launches"] != res["expected_launches"]:
                raise AssertionError(f"spatial {name} rank {r}: launches {p['launches']}, "
                                     f"expected {res['expected_launches']}")
            sums.update(p["launches"])
    return dict(sums)


def _check_multiseed(ranks: list, smi: str) -> None:
    ms = [r["multiseed"] for r in ranks]
    seeds = [s for m in ms for s in m["seeds"]]
    emit("multiseed", ranks=len(ranks), seeds_per_rank=MULTISEED_PER_RANK, lr=MULTISEED_LR,
         global_batch=CONFIG["batch_size"], image=IMAGE, **MULTISEED_CASE, card=smi,
         seeds=seeds, losses=[m["losses"] for m in ms],
         losses_one_process=[m["losses_one_process"] for m in ms],
         max_abs_param_diff=[m["max_abs_param_diff"] for m in ms],
         bit_identical=[m["bit_identical"] for m in ms], seconds=[m["seconds"] for m in ms],
         launches_per_rank=[_nonzero(m["launches"]) for m in ms],
         expected_launches_per_rank=[_nonzero(m["expected_launches"]) for m in ms])
    if seeds != list(range(MULTISEED_PER_RANK * len(ranks))):
        raise AssertionError(f"multiseed: the ranks hold seeds {seeds}")
    losses = [x for m in ms for x in m["losses"]]
    if len(set(losses)) != len(losses) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"multiseed: the seeds' losses are not distinct and finite: {losses}")
    for r, m in enumerate(ms):
        # Adam moves a parameter by about lr a step, so a gradient element
        # that rounds to the other sign moves it 2·lr away
        if (max(abs(a - b) / abs(b) for a, b in zip(m["losses"], m["losses_one_process"])) > 1e-6
                or m["max_abs_param_diff"] > 2 * MULTISEED_LR):
            raise AssertionError(f"multiseed rank {r}: off the one-process steps: {m}")
        if m["launches"] != m["expected_launches"]:
            raise AssertionError(f"multiseed rank {r}: launches {m['launches']}, expected "
                                 f"{m['expected_launches']}")
        require_launches(f"multiseed rank {r}", m["launches"],
                         ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"]
                         + DP_FUSED_KERNELS["pallas_fused"])


def _check_dp_multistep(ranks: list, smi: str) -> None:
    """The dp_multistep lines and checks: over NCCL each config's replay bit
    for bit its eager mesh steps on every rank, the same bits on every
    rank, each port kernel MULTISTEP_N times an eager step's launches in
    one replay; over gloo the NCCL refusal on every rank."""
    ms = [r["multistep"] for r in ranks]
    if ms[0]["backend"] != "nccl":
        emit("dp_multistep", ranks=len(ranks), backend=ms[0]["backend"], captured=False,
             reason="the ranks share one card over gloo, whose collectives on CUDA tensors go "
                    "through the host and cannot be captured in a CUDA graph; "
                    "make_train_multistep refuses it",
             refusal=[m["refusal"] for m in ms], card=smi)
        if any(m["refusal"] is None or "NCCL" not in m["refusal"] for m in ms):
            raise AssertionError(f"dp_multistep: gloo ranks on CUDA were not refused: {ms}")
        return
    for tag, over in MULTISTEP_CONFIGS:
        per = [m["configs"][tag] for m in ms]
        res = per[0]
        emit("dp_multistep", config=tag, ranks=len(ranks), backend=ms[0]["backend"],
             captured=True, steps=MULTISTEP_N, global_batch=CONFIG["batch_size"], image=IMAGE,
             eager_ms=_spread(res["eager_ms"]), graph_ms=_spread(res["graph_ms"]),
             dispatch_ms=float(np.median(res["eager_ms"]) - np.median(res["graph_ms"])),
             eager_ms_per_rank=[_spread(p["eager_ms"]) for p in per],
             graph_ms_per_rank=[_spread(p["graph_ms"]) for p in per],
             bit_identical=[p["bit_identical"] for p in per],
             max_abs_diff=[p["max_abs_diff"] for p in per], worst=[p["worst"] for p in per],
             replicas_equal=[p["replicas_equal"] for p in per],
             last_loss=[p["last_loss"] for p in per],
             capture_s=[p["capture_s"] for p in per], peak_mib=[p["peak_mib"] for p in per],
             eager_peak_mib=[p["eager_peak_mib"] for p in per],
             eager_launches=res["eager_launches"], replay_launches=res["replay_launches"],
             replay_launches_per_rank=[p["replay_launches"] for p in per],
             eager_sessions=res["eager_sessions"], replay_sessions=res["replay_sessions"],
             captured_counts=res["captured_counts"], card=smi)
        for r, p in enumerate(per):
            if not p["bit_identical"]:
                raise AssertionError(f"dp_multistep {tag} rank {r}: the replay is not the eager "
                                     f"mesh steps bit for bit: {p['max_abs_diff']} at "
                                     f"{p['worst']}, last loss {p['last_loss']} against "
                                     f"{p['eager_last_loss']}")
            if not p["replicas_equal"]:
                raise AssertionError(f"dp_multistep {tag}: rank {r} holds other bits than rank 0")
            eager, replay = (collections.Counter(p[k]) for k in ("eager_launches",
                                                                  "replay_launches"))
            wrong = {b: (eager[b], replay[b]) for b in set(eager) | set(replay)
                     if replay[b] != MULTISTEP_N * eager[b]}
            missing = [b for b in MULTISTEP_PORT_BUCKETS[tag] if eager[b] <= 0]
            if missing or wrong:
                raise AssertionError(f"dp_multistep {tag} rank {r}: kernels missing {missing}, "
                                     f"replay launches not {MULTISTEP_N}x eager: {wrong}")


def phase_dp(config: dict, calib, serve, smi: str) -> dict:
    """Phase 24: the dp phase's ranks (module docstring), their lines and
    checks → the launches of every rank's paths."""
    cfg = dict(config)
    n = dp_ranks()
    st = add_uncertainty(build_trunk(cfg), cfg,
                         generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    weights = {k: v.detach().cpu() for k, v in st.model.state_dict().items()}
    del st
    x, y, mask = path_batch(cfg)
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        torch.save(weights, tmp / "weights.pt")
        np.savez(tmp / "data.npz", x=x, y=y, mask=mask,
                 calib_x=np.stack([calib[i][0] for i in range(len(calib))]),
                 calib_y=np.stack([calib[i][1] for i in range(len(calib))]))
        np.save(tmp / "serve.npy", np.stack([serve[i][0] for i in range(len(serve))]))
        exports = _dp_inputs(tmp, cfg, weights, n)
        gc.collect()
        torch.cuda.empty_cache()  # the ranks share the card
        t0 = time.perf_counter()
        ranks = _spawn_dp_ranks(tmp, n)
        wall = time.perf_counter() - t0
    r0 = ranks[0]
    for name, res in r0["train"].items():
        per_rank = [r["train"][name]["launches"] for r in ranks]
        timed = {k: _spread(res[k]) for k in ("steps_ms", "steps_ms_one_process",
                                              "steps_ms_shard_one_process")}
        emit("dp_train", case=name, ranks=n, backend=r0["backend"],
             devices=[r["device"] for r in ranks], global_batch=cfg["batch_size"], image=IMAGE,
             lr=DP_LR, cpu_bars={"rtol": DP_CPU_RTOL, "atol": DP_CPU_ATOL},
             card=smi, **{k: v for k, v in res.items() if k != "launches" and k not in timed},
             step_ms=timed["steps_ms"], step_ms_one_process=timed["steps_ms_one_process"],
             step_ms_shard_one_process=timed["steps_ms_shard_one_process"],
             step_ms_per_rank=[_spread(r["train"][name]["steps_ms"]) for r in ranks],
             launches_per_rank=per_rank)
        if {r["train"][name]["loss"] for r in ranks} != {res["loss"]}:
            raise AssertionError(f"dp_train {name}: the ranks' losses differ")
        for r, counts in enumerate(per_rank):
            require_launches(f"dp_train {name} rank {r}", counts,
                             ["upsample2x", "upsample2x_bwd", "maxpool2x2_bwd"]
                             + DP_FUSED_KERNELS.get(name, []))
        bf16 = name.endswith("bf16")
        loss_bar = BF16_LOSS_RTOL if bf16 else FUSED_LOSS_RTOL
        stat_bar = BF16_STAT_RTOL if bf16 else FUSED_STAT_RTOL
        grad_bad = (res["whole_grad_err"] > BF16_GRAD_RTOL if bf16
                    else res["max_grad_err"] > GRAD_RTOL)
        if res["loss_rel_err"] > loss_bar or grad_bad or res["max_stat_err"] > stat_bar:
            raise AssertionError(f"dp_train {name}: the 2-rank step is off the one-process step: "
                                 f"{res}")
        if not bf16 and not res["within_cpu_bars"]:
            raise AssertionError(f"dp_train {name}: the parameters or running statistics are "
                                 f"outside the CPU test's bars: {res}")
    cal = [r["calibrate"] for r in ranks]
    emit("dp_calibrate", ranks=n, conv_backend="pallas_fused", images=len(calib),
         num_lambdas=cfg["num_lambdas"], lhat=[c["lhat"] for c in cal],
         lhat_one_process=cal[0]["lhat_one_process"],
         table_atol=DP_TABLE_ATOL, table_max_abs_diff=cal[0]["table_max_abs_diff"],
         table_bit_identical=cal[0]["table_bit_identical"],
         whole_table_max_abs_diff=cal[0]["whole_table_max_abs_diff"],
         whole_table_bit_identical=cal[0]["whole_table_bit_identical"],
         risks_vs_table=[c["risks_vs_table"] for c in cal],
         risks_vs_one_process=cal[0]["risks_vs_one_process"],
         seconds=[c["seconds"] for c in cal], launches_per_rank=[c["launches"] for c in cal],
         risks_launches_per_rank=[c["risks_launches"] for c in cal])
    # λ̂ of random weights sits at the grid's top, so its equality alone shows
    # little: the tables carry the check
    if len({c["lhat"] for c in cal} | {cal[0]["lhat_one_process"]}) != 1:
        raise AssertionError(f"dp_calibrate: λ̂ differs between the ranks or from one process")
    if max(cal[0]["table_max_abs_diff"], cal[0]["whole_table_max_abs_diff"]) > DP_TABLE_ATOL:
        raise AssertionError("dp_calibrate: the loss table over the mesh is off one process's")
    if max(c["risks_vs_table"] for c in cal) > 1e-6 or cal[0]["risks_vs_one_process"] > 1e-6:
        raise AssertionError("dp_calibrate: compute_risks_device is off the table's column means")
    for r, c in enumerate(cal):
        for what in ("launches", "risks_launches"):
            require_launches(f"dp_calibrate rank {r} {what}", c[what],
                             ["loss_table", "upsample2x", "conv3x3", "conv3x3_bn_act"])
    srv = [r["serve"] for r in ranks]
    emit("dp_serve", ranks=n, conv_backend="pallas_fused", images=len(serve),
         rc=[s["rc"] for s in srv], max_abs_diff=srv[0]["max_abs_diff"],
         bit_identical=srv[0]["bit_identical"], lam=srv[0]["lam"],
         imgs_per_sec=srv[0]["summary"]["imgs_per_sec"], seconds=srv[0]["summary"]["seconds"],
         launches_per_rank=[s["launches"] for s in srv])
    if any(s["rc"] != 0 for s in srv) or srv[0]["lam"] != cal[0]["lhat"]:
        raise AssertionError(f"dp_serve: infer.main failed or served another λ: {srv}")
    if srv[0]["max_abs_diff"] > 1e-4:
        raise AssertionError(f"dp_serve: the intervals are {srv[0]['max_abs_diff']} from one "
                             "process")
    for r, s in enumerate(srv):
        require_launches(f"dp_serve rank {r}", s["launches"],
                         ["upsample2x", "conv3x3", "conv3x3_bn_act"])
    _check_dp_artifact(ranks, exports, smi)
    _check_spatial(ranks, smi)
    _check_multiseed(ranks, smi)
    _check_dp_multistep(ranks, smi)
    emit("dp", ranks=n, backend=r0["backend"], seconds=wall, card=smi,
         cards="one, shared by the ranks" if r0["device"] == ranks[1]["device"] else "one a rank")
    return {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    config = dict(infer.DEFAULTS, **CONFIG)
    grid = lambda_grid(config)
    lam = torch.from_numpy((grid - (grid[1] - grid[0])).astype(np.float32)).cuda()
    measured = {
        "upsample2x": phase_k1(),
        "upsample2x_bwd": phase_k1b(),
        "loss_table": phase_k2(lam),
        "maxpool2x2_bwd": phase_k7(),
        **phase_conv_kernels(),
        **phase_conv_kernels_bf16(),
        **phase_activation_bf16(),
        **phase_conv_bwd_bf16(),
    }
    measured.update(phase_probes())
    launches = phase_probe_cli()

    # 5-6. calibrate and serve
    t0 = time.perf_counter()
    calib = synthetic(CALIB_N, IMAGE, seed=0)
    serve = synthetic(SERVE_N, IMAGE, seed=1)
    emit("data", images=CALIB_N + SERVE_N, image=IMAGE, seconds=time.perf_counter() - t0)
    state = add_uncertainty(
        build_trunk(config), config,
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda",
    )
    state, xs, calib_serve_counts, _ = calibrate_and_serve("", state, config, calib, serve, [])

    # 7. crosscheck: CPU (plain versions) vs the card, fp32, TF32 off
    x2 = nchw_from_nhwc(xs[:2], "cpu")
    on_gpu = state.nested_sets(x2.cuda())
    cpu_state = UQState(model=copy.deepcopy(state.model).cpu(), params=state.params,
                        lhat=state.lhat)
    on_cpu = cpu_state.nested_sets(x2)
    rtol, atol = 1e-4, 1e-5
    errs = []
    for g_t, c_t in zip(on_gpu, on_cpu):
        g_t = g_t.cpu()
        errs.append((g_t - c_t).abs().max().item())
        if not torch.allclose(g_t, c_t, rtol=rtol, atol=atol):
            raise AssertionError(f"CPU and GPU nested sets differ: max abs {errs[-1]}")
    emit("crosscheck", batch=2, rtol=rtol, atol=atol, max_abs_err=errs)
    del state, cpu_state, on_gpu, on_cpu

    # 8-10. train, the router, and the CPU/GPU check of a train step
    train_counts, init, train_cfg = phase_train(config)
    router_counts = phase_router()
    phase_gradcheck(init, train_cfg)
    # 11-13. the fused-conv configs: train, compare, calibrate, serve, router
    fused_counts = phase_fused(config, calib, serve)
    router_fused_counts = phase_router(
        "router_fused", {"conv_backend": "pallas_fused"},
        DEFAULT_PATH_KERNELS + ["conv3x3_bn_act", "conv3x3", "wgrad3x3", "dgrad3x3"])
    # 14-16. the other heads, WNet, and the router with the softmax head
    heads_counts = phase_heads(config, calib, serve)
    wnet_counts = phase_wnet(config)
    router_softmax_counts = phase_router("router_softmax", {"uncertainty_type": "softmax"})
    # 17-21. compute_dtype bfloat16: the main path, the gradcheck of the fused
    # step, the other heads and WNet, the router under xla and pallas_fused
    bf16_counts = phase_bf16(config, calib, serve)
    phase_bf16_gradcheck(config)
    bf16_model_counts = phase_bf16_models(config)
    router_bf16_counts = phase_router("router_bf16", {"compute_dtype": "bfloat16"})
    router_bf16_fused_counts = phase_router(
        "router_bf16_fused", {"compute_dtype": "bfloat16", "conv_backend": "pallas_fused"},
        DEFAULT_PATH_KERNELS + BF16_TRAIN_KERNELS["pallas_fused"])
    # 21. remat
    remat_counts = phase_remat(config)
    # 22. deploy: the calibrate CLI, the serving artifact, serving from it
    deploy_counts = phase_deploy(config, calib, serve)
    # 23. data_device: fastMRI k-space and TEMCA uint8 patches made into the
    # model's inputs inside the train step
    data_device_counts = phase_data_device(config, smi)
    # 24-26. grain with mid-epoch checkpoints, the multistep CUDA graph, and
    # the ResNet18 trunk
    t0 = time.perf_counter()
    midepoch_counts = phase_midepoch(config, smi)
    t1 = time.perf_counter()
    multistep_counts = phase_multistep(config, smi)
    t2 = time.perf_counter()
    resnet_counts = phase_resnet(config, smi)
    emit("phase_seconds", midepoch=t1 - t0, multistep=t2 - t1,
         resnet=time.perf_counter() - t2)
    # 27. dp: training, calibration, serving, the data-parallel artifact,
    # height-sharded serving and multi-seed training over the ranks
    dp_counts = phase_dp(config, calib, serve, smi)
    for counts in (calib_serve_counts, train_counts, router_counts, fused_counts,
                   router_fused_counts, heads_counts, wnet_counts, router_softmax_counts,
                   bf16_counts, bf16_model_counts, router_bf16_counts, router_bf16_fused_counts,
                   remat_counts, deploy_counts, data_device_counts, midepoch_counts,
                   multistep_counts, resnet_counts, dp_counts):
        for name, n in counts.items():
            launches[name] += n

    sources = {
        "upsample2x": ("upsample2x.cu", "im2im_uq_tpu/ops/pallas_resize.py:185"),
        "upsample2x_bwd": ("upsample2x_bwd.cu", "im2im_uq_tpu/ops/pallas_resize.py:273"),
        "loss_table": ("loss_table.cu", "im2im_uq_tpu/ops/pallas_kernels.py:89"),
        "maxpool2x2_bwd": ("maxpool2x2_bwd.cu", "im2im_uq_tpu/ops/pallas_pool.py:114"),
        "conv3x3": ("conv3x3.cu", "im2im_uq_tpu/ops/pallas_conv.py:190"),
        "conv3x3_bn_act": ("conv3x3.cu", "im2im_uq_tpu/ops/pallas_conv.py:234"),
        "conv3x3_bf16": ("conv3x3_bf16.cu", "im2im_uq_tpu/ops/pallas_conv.py:190"),
        "conv3x3_bn_act_bf16": ("conv3x3_bf16.cu", "im2im_uq_tpu/ops/pallas_conv.py:234"),
        "wgrad3x3": ("wgrad3x3.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:191"),
        "wgrad3x3_tma": ("wgrad3x3_tma.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:191"),
        "dgrad3x3": ("dgrad3x3.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:315"),
        "dgrad3x3_tma": ("dgrad3x3_tma.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:315"),
        "wgrad3x3_bf16": ("conv3x3_bf16.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:191"),
        "dgrad3x3_bf16": ("conv3x3_bf16.cu", "im2im_uq_tpu/ops/pallas_conv_bwd.py:315"),
        "cotangent_nhwc": ("conv3x3_bf16.cu", "im2im_uq_tpu/ops/pallas_conv.py:371"),
        "activation_nhwc": ("conv3x3_bf16.cu", "im2im_uq_tpu/ops/pallas_conv.py:153"),
        "moments": ("moments.cu", "benchmarks/bench_moments.py:51"),
        "conv3x3_single": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:51"),
        "conv3x3_db": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:122"),
        "conv3x3_l1": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:196"),
        "conv3x3_c64": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:293"),
        "conv3x3_single_f32": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:51"),
        "conv3x3_db_f32": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:122"),
        "conv3x3_l1_f32": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:196"),
        "conv3x3_c64_f32": ("conv3x3_nhwc.cu", "benchmarks/bench_pallas_conv.py:293"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": f"im2im_uq_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name], **measured[name]}
        for name, (src, replaces) in sources.items()
    ]
    require_launches("main path", launches, KERNELS)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dp_only() -> int:
    """``--dp-only``: env, build and the dp phase alone (on four cards, the
    multi-GPU paths over NCCL without the single-process phases); no
    result line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    counts = phase_dp(dict(infer.DEFAULTS, **CONFIG), synthetic(CALIB_N, IMAGE, seed=0),
                      synthetic(SERVE_N, IMAGE, seed=1), smi)
    emit("dp_only", seconds=time.perf_counter() - t0, launches=_nonzero(counts))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        raise SystemExit(dp_worker(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--dp-only"]:
        raise SystemExit(dp_only())
    raise SystemExit(main())
