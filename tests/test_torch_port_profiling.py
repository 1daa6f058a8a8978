"""``utils/profiling.py``: its None cases, ``time_fn``, and the buckets.

On the CPU no device kernel is traced, so the readers return None as the
JAX package's do where its trace holds no device ops; ``measure_device_busy``
of CPU work is None too. A Chrome trace written here with device events
(the ``kernel`` / ``gpu_memcpy`` categories a CUDA trace of
``torch.profiler`` carries) is read back into per-bucket and per-kernel
device ms; ``scripts/profile_step.py`` reads the same buckets.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from im2im_uq_tpu.utils import profiling as jprof

from im2im_uq_tpu_torch.scripts import profile_step
from im2im_uq_tpu_torch.utils import profiling
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)


def test_readers_return_none_without_a_trace(tmp_path):
    for mod in (profiling, jprof):
        assert mod.device_busy_breakdown(str(tmp_path)) is None
        assert mod.device_busy_ops(str(tmp_path)) is None


def test_a_cpu_trace_has_no_device_kernels(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        (x @ x).sum()
    assert os.path.exists(tmp_path / profiling.TRACE_FILE)
    assert profiling.trace_kernels(str(tmp_path)) == []
    assert profiling.device_busy_breakdown(str(tmp_path), steps=2) is None
    assert profiling.device_busy_ops(str(tmp_path)) is None
    assert profiling.measure_device_busy(lambda a: a @ a, x, steps=2) is None


def test_measure_device_busy_is_best_effort():
    def boom():
        raise RuntimeError("no")

    assert profiling.measure_device_busy(boom) is None


@pytest.mark.parametrize("warmup, iters, windows", [(1, 3, 2), (0, 1, 1), (2, 2, 3)])
def test_time_fn_counts_and_keys(warmup, iters, windows):
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    out = profiling.time_fn(fn, torch.ones(3), warmup=warmup, iters=iters, windows=windows)
    assert len(calls) == max(warmup, 1) + iters * windows
    assert set(out) == {"best_sec_per_call", "mean_sec_per_call", "compile_sec"}
    assert set(out) == set(jprof.time_fn(lambda a: a, np.ones(2), iters=1, windows=1))
    assert 0 < out["best_sec_per_call"] <= out["mean_sec_per_call"]
    assert out["compile_sec"] >= 0


def _chrome_trace(path, events):
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)


def test_breakdown_of_a_device_trace(tmp_path):
    ev = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                              "dur": dur, "pid": 0, "tid": 7}
    _chrome_trace(tmp_path / "trace.json", [
        ev("void conv3x3_fwd_kernel<true, true>(...)", 0, 40),
        ev("void (anonymous namespace)::k5::wgrad_kernel<3>(...)", 40, 20),
        ev("sm90_xmma_fprop_implicit_gemm_f32f32", 60, 30),
        ev("Memcpy HtoD (Pageable -> Device)", 100, 10, cat="gpu_memcpy"),
        ev("void at::native::vectorized_elementwise_kernel<4>(...)", 95, 10),
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 500},
        {"ph": "M", "name": "process_name", "pid": 0},
    ])
    out = profiling.device_busy_breakdown(str(tmp_path), steps=2)
    assert out["categories"] == {"K3/K4 conv3x3 (port)": 20.0 / 1e3,
                                 "conv (cuDNN)": 15.0 / 1e3,
                                 "K5 wgrad3x3 (port)": 10.0 / 1e3,
                                 "copies and fills": 5.0 / 1e3,
                                 profiling.OTHER: 5.0 / 1e3}
    assert out["total_ms"] == pytest.approx(110.0 / 2 / 1e3)
    assert out["busy_ms"] == pytest.approx(105.0 / 2 / 1e3)  # the union: 0-90 and 95-110
    ops = profiling.device_busy_ops(str(tmp_path), steps=1, top=2)
    assert ops["ops"] == [("void conv3x3_fwd_kernel<true, true>(...)", 0.04),
                          ("sm90_xmma_fprop_implicit_gemm_f32f32", 0.03)]
    assert ops["total_ms"] == pytest.approx(0.11)


def test_union_and_the_buckets_profile_step_reads():
    assert profiling.union_us([(0, 4), (2, 6), (8, 9), (8.5, 8.7)]) == 7
    assert profiling.union_ms([("a", 0, 1000), ("b", 500, 1500)]) == 1.5
    assert profile_step.bucket is profiling.bucket
    assert profiling.bucket("void upsample2x_tile_kernel<8>(...)") == "K1f upsample (port)"
    assert profiling.bucket("void maxpool2x2_bwd_kernel<float>(...)") == \
        "K7 max-pool backward (port)"
    assert profiling.bucket("multi_tensor_apply_kernel<...>") == "Adam (foreach)"
    assert profiling.breakdown([]) is None
