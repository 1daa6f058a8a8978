"""Profiling and timing on ``torch.profiler`` and CUDA events.

Counterpart of ``im2im_uq_tpu/utils/profiling.py``: :func:`trace` records a
profiler trace into a directory (a Chrome trace, ``trace.json``);
:func:`time_fn` times steady-state calls fenced by ``torch.cuda.synchronize``
after warm-up; :func:`device_busy_breakdown` and :func:`device_busy_ops`
turn a recorded trace into device time per kernel bucket and per kernel;
:func:`measure_device_busy` records ``steps`` calls of a function and
returns its breakdown. Like the JAX functions, the readers return None
where no trace was written or no device kernel was traced (a CPU run), and
``measure_device_busy`` is best-effort.

The buckets (:func:`bucket`) name the port's kernels first (their names
contain "conv" too), then cuDNN's convolutions, BatchNorm, Adam, copies and
the rest; ``scripts/profile_step.py`` and ``chip_smoke.py`` read them here.
Device time is the kernels' own durations (a stream runs one kernel at a
time, so there is nothing nested to subtract, unlike XLA's control-flow
ops); :func:`union_ms` is the busy time, the union of their intervals.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Callable, Iterable, Optional

import torch

__all__ = [
    "bucket",
    "breakdown",
    "device_busy_breakdown",
    "device_busy_ops",
    "kernel_events",
    "measure_device_busy",
    "time_fn",
    "trace",
    "trace_kernels",
    "union_ms",
    "union_us",
]

# (name, start µs, end µs) of one device kernel, memcpy or memset
Kernel = tuple[str, float, float]

# (bucket, substrings of the kernel name), first match wins: the port's
# kernels first, since their names contain "conv" too
BUCKETS = [
    # f32: conv3x3_fwd_kernel; bf16: conv3x3_fwd_wgmma_kernel (K6's body with
    # the forward's epilogue); the stem, conv3x3_fwd_stem_kernel
    ("K3/K4 conv3x3 (port)", ("conv3x3_fwd",)),
    # f32: wgrad3x3_tma_kernel and, for the stem and the shapes off its plan,
    # wgrad3x3_tc_kernel; bf16: k5::wgrad_kernel and its stem (demangled or
    # mangled names)
    ("K5 wgrad3x3 (port)", ("wgrad3x3_tma_kernel", "wgrad3x3_tc_kernel", "k5::wgrad",
                            "2k512wgrad_kernel", "2k517wgrad_stem_kernel")),
    # f32: dgrad3x3_tma_kernel and its weight pack, and for the shapes off
    # its plan dgrad3x3_tc_kernel; bf16: k6::dgrad_kernel
    ("K6 dgrad3x3 (port)", ("dgrad3x3_tma_kernel", "k6f::pack_weights", "3k6f19pack_weights",
                            "dgrad3x3_tc_kernel", "k6::dgrad_kernel", "2k612dgrad_kernel")),
    # the bf16 GEMMs' operands: the NHWC activation (K3/K4's and K5's) and
    # cotangent passes, the packed weights of K3/K4 and K6
    ("bf16 packing (port)", ("nhwc_kernel", "pack_weights_k6")),
    ("fixed-order partial sums (port)", ("reduce_rows",)),
    # f32: upsample2x_kernel, upsample2x_bwd_kernel; bf16: the row-tiled
    # upsample2x_tile_kernel<V>, upsample2x_bwd_tile_kernel<V>
    ("K1f upsample (port)", ("upsample2x_kernel", "upsample2x_tile_kernel")),
    ("K1b upsample backward (port)", ("upsample2x_bwd_kernel", "upsample2x_bwd_tile_kernel")),
    ("K7 max-pool backward (port)", ("maxpool2x2_bwd_kernel",)),
    ("batchnorm (cuDNN / torch)", ("batch_norm", "bn_fw", "bn_bw", "welford", "bn_")),
    ("conv (cuDNN)", ("conv", "xmma", "implicit", "winograd", "fft", "cudnn", "gemm",
                      "cutlass", "flip_filter", "wgrad", "dgrad",
                      "pointwise_mult_and_sum_complex")),  # cuDNN's FFT convs
    ("Adam (foreach)", ("multi_tensor", "adam")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
]
OTHER = "other elementwise and reductions"
TRACE_FILE = "trace.json"


def bucket(name: str) -> str:
    low = name.lower()
    for label, keys in BUCKETS:
        if any(k in low for k in keys):
            return label
    return OTHER


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into
    ``logdir/trace.json`` (Chrome's format; open with Perfetto or
    ``chrome://tracing``). The block's device work is synchronized first."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10, windows: int = 3) -> dict:
    """Steady-state timing: warm-up calls first, then ``windows`` windows of
    ``iters`` calls, each fenced by ``torch.cuda.synchronize`` → {
    'best_sec_per_call', 'mean_sec_per_call', 'compile_sec'} (the warm-up's
    seconds, where the JAX function's compile lands)."""
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync()
    compile_sec = time.perf_counter() - t0
    samples = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync()
        samples.append((time.perf_counter() - t0) / iters)
    return {"best_sec_per_call": min(samples),
            "mean_sec_per_call": sum(samples) / len(samples),
            "compile_sec": compile_sec}


def kernel_events(prof) -> list[Kernel]:
    """The device kernels (and memcpys, memsets) of a finished
    ``torch.profiler.profile``."""
    return [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def trace_kernels(trace_dir: str) -> Optional[list[Kernel]]:
    """The device kernels of the newest trace under ``trace_dir``; None
    where there is no trace file."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        return None
    with open(files[-1]) as fh:
        events = json.load(fh).get("traceEvents", [])
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]


def union_us(intervals: Iterable[tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def union_ms(kernels: Iterable[Kernel]) -> float:
    """Busy time: the union of the kernels' intervals, in ms."""
    return union_us((a, b) for _, a, b in kernels) / 1e3


def breakdown(kernels: list[Kernel], steps: int = 1) -> Optional[dict]:
    """Device ms per step: {'total_ms', 'busy_ms', 'categories': {bucket:
    ms}}, the categories largest first; None without kernels."""
    if not kernels:
        return None
    cats: dict[str, float] = {}
    for name, a, b in kernels:
        cats[bucket(name)] = cats.get(bucket(name), 0.0) + (b - a) / 1e3 / steps
    return {"total_ms": sum(cats.values()), "busy_ms": union_ms(kernels) / steps,
            "categories": dict(sorted(cats.items(), key=lambda kv: -kv[1]))}


def device_busy_breakdown(trace_dir: str, steps: int = 1) -> Optional[dict]:
    """:func:`breakdown` of the trace under ``trace_dir``, or None."""
    kernels = trace_kernels(trace_dir)
    return None if kernels is None else breakdown(kernels, steps)


def device_busy_ops(trace_dir: str, steps: int = 1, top: int = 25) -> Optional[dict]:
    """The ``top`` kernels by device ms per step: {'total_ms', 'ops': [(name,
    ms)]}, or None where no device kernel was traced."""
    kernels = trace_kernels(trace_dir)
    if not kernels:
        return None
    ops: dict[str, float] = {}
    for name, a, b in kernels:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e3 / steps
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])
    return {"total_ms": sum(ops.values()), "ops": ranked[:top]}


def measure_device_busy(fn: Callable, *args, steps: int = 3) -> Optional[dict]:
    """``fn(*args)`` ``steps`` times under :func:`trace` → its
    :func:`device_busy_breakdown`, or None where profiling fails or traces no
    device kernel."""
    import tempfile

    try:
        with tempfile.TemporaryDirectory() as td:
            with trace(td):
                for _ in range(steps):
                    fn(*args)
            return device_busy_breakdown(td, steps=steps)
    except Exception:
        return None  # profiling is best-effort, as in the JAX package
