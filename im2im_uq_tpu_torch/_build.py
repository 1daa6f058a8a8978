"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library goes to ``build/im2im_uq_tpu_torch/<hash>/`` at the repository root,
keyed by a hash of the sources, the ``csrc/*.cuh`` headers they include and
the flags, so an edited source rebuilds and an unchanged one is loaded as it
is. The wrappers in ``ops/`` pass
tensor pointers and PyTorch's current stream as ``c_void_p``.

Nothing here runs at import time: the first CUDA call of a kernel wrapper
calls :func:`library`. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildInfo", "build", "check", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "im2im_uq_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libim2im_uq_kernels.so"

_P = ctypes.c_void_p
_SIGNATURES = {
    # (x, y, wh, ww, planes, h, w, kind, device, stream)
    "im2im_upsample2x": (
        [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    # the bf16 K1 kernels' plan: (h, w, vec, out[6])
    "im2im_upsample2x_plan": ([ctypes.c_int] * 3 + [_P], ctypes.c_int),
    # (pred, label, dl, du, lam, out, scratch, n, num_px, num_lam, vec, device,
    #  stream)
    "im2im_loss_table": (
        [_P] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, _P],
        ctypes.c_int,
    ),
    # int32 elements of K2's scratch, or minus a CUDA error: (n, num_px,
    #  num_lam, vec, device)
    "im2im_loss_table_scratch": (
        [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
        ctypes.c_longlong),
    # (g, dx, ah, aw, planes, h, w, kind, device, stream); h, w are dx's
    "im2im_upsample2x_bwd": (
        [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    # (x, g, dx, planes, h, w, dtype, device, stream); h, w are x's
    "im2im_maxpool2x2_bwd": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    # K3 and K4 (f32; the bf16 stem): (x, weight, bias, scale, shift, y, part,
    #      stats, b, cin, cout, h, w, prologue, with_stats, dtype, device, stream)
    "im2im_conv3x3_fused": ([_P] * 8 + [ctypes.c_int] * 9 + [_P], ctypes.c_int),
    # floats of K4's stats scratch: (b, cout, h, w)
    "im2im_conv3x3_scratch": ([ctypes.c_int] * 4, ctypes.c_longlong),
    # K3 and K4 in bf16 on wgmma: (xp, weight, bias, y, wpack, part, stats, b,
    #  cin, cp, cout, h, w, bn, th, tw, stages, blocks, device, stream)
    "im2im_conv3x3_wgmma": ([_P] * 7 + [ctypes.c_int] * 12 + [_P], ctypes.c_int),
    # K5 in f32: (x, g, scale, shift, scratch, dw, db, b, cin, cout, h, w,
    #      prologue, device, stream)
    "im2im_wgrad3x3": ([_P] * 7 + [ctypes.c_int] * 7 + [_P], ctypes.c_int),
    # floats of K5's split-K scratch: (b, cin, cout, h, w)
    "im2im_wgrad3x3_scratch": ([ctypes.c_int] * 5, ctypes.c_longlong),
    # K5 in f32 on wgmma with TMA: (x, g, scale, shift, part, dw, db, b, cin,
    #      cout, h, w, prologue, tw, stages, per_slice, slices, device, stream)
    "im2im_wgrad3x3_tma": ([_P] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 2 + [_P], ctypes.c_int),
    # K6 in f32: (g, weight, x, scale, shift, dx, part, red, b, cin, cout, h, w,
    #      prologue, device, stream)
    "im2im_dgrad3x3": ([_P] * 8 + [ctypes.c_int] * 7 + [_P], ctypes.c_int),
    # floats of K6's reduction scratch: (b, cin, h, w)
    "im2im_dgrad3x3_scratch": ([ctypes.c_int] * 4, ctypes.c_longlong),
    # K6 in f32 on wgmma with TMA: (g, weight, x, scale, shift, dx, wpack, part,
    #      red, b, cin, cout, h, w, prologue, th, tw, hc, rows, stages,
    #      per_slice, device, stream)
    "im2im_dgrad3x3_tma": ([_P] * 9 + [ctypes.c_int] * 13 + [_P], ctypes.c_int),
    # floats of its packed weights: (cin, cout)
    "im2im_dgrad3x3_tma_scratch": ([ctypes.c_int] * 2, ctypes.c_longlong),
    # the bf16 NHWC passes (mode 0: K5's activation, 1: the cotangent): (in, y,
    #  gst, scale, shift, out, b, c, cp, h, w, mode, device, stream)
    "im2im_nhwc_pass": ([_P] * 6 + [ctypes.c_int] * 7 + [_P], ctypes.c_int),
    # K6 in bf16 on wgmma: (gp, weight, x, scale, shift, dx, wpack, part, red,
    #  b, cin, cout, cp, h, w, prologue, bn, th, tw, stages, blocks, device,
    #  stream)
    "im2im_dgrad3x3_wgmma": ([_P] * 9 + [ctypes.c_int] * 13 + [_P], ctypes.c_int),
    # K5 in bf16 on wgmma: (act, gp, part, dw, db, b, cin, cpi, cout, cpo, h, w,
    #  th, tw, stages, per_slice, slices, device, stream)
    "im2im_wgrad3x3_wgmma": ([_P] * 5 + [ctypes.c_int] * 13 + [_P], ctypes.c_int),
    # K5's bf16 stem: (x, gp, scale, shift, part, dw, db, b, cout, cpo, h, w,
    #  prologue, per_slice, slices, device, stream)
    "im2im_wgrad3x3_stem": ([_P] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong]
                            + [ctypes.c_int] * 2 + [_P], ctypes.c_int),
    # P1: blocks of the partial buffer for (n rows, device)
    "im2im_moments_blocks": ([ctypes.c_longlong, ctypes.c_int], ctypes.c_int),
    # P1: (x, part, sums, n, c, blocks, dtype, vec, device, stream)
    "im2im_moments": (
        [_P, _P, _P, ctypes.c_longlong] + [ctypes.c_int] * 5 + [_P], ctypes.c_int),
    # P2-P5: (x, kernel, y, b, h, w, cin, cout, variant, dtype, vec_x, vec_w,
    #         device, stream)
    "im2im_conv3x3_nhwc": ([_P] * 3 + [ctypes.c_int] * 10 + [_P], ctypes.c_int),
    # P2-P5's path on wgmma with TMA: (x, kernel, y, wpack, b, h, w, cin, cout,
    #         bn, groups, stages, dtype, device, stream)
    "im2im_conv3x3_nhwc_tma": ([_P] * 4 + [ctypes.c_int] * 10 + [_P], ctypes.c_int),
    # bytes of its packed weights: (cin, cout, bn, groups, dtype)
    "im2im_conv3x3_nhwc_tma_scratch": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "im2im_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """Where the library is, whether this call compiled it, how long that
    took, and nvcc's output (with ``-Xptxas -v``: registers and shared
    memory per kernel)."""

    path: Path
    compiled: bool
    seconds: float
    log: str


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA kernels "
        "of im2im_uq_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):  # the headers they include too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into the hash-keyed library unless it exists.

    One ``nvcc -c`` per source, all running at once, then one link. Every
    process started here is waited for before this returns or raises.
    """
    sources = _sources()
    out = BUILD_ROOT / _digest(sources) / _LIB_NAME
    if out.exists():
        return BuildInfo(out, False, 0.0, "")
    nvcc = nvcc_path()
    work = out.parent / f"objects.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"exit code {proc.returncode}: {' '.join(cmd)}\n{text}")
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"exit code {proc.returncode}: {' '.join(link)}\n{logs[-1]}")
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return BuildInfo(out, True, time.perf_counter() - t0, "".join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        text = library().im2im_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({text})")
