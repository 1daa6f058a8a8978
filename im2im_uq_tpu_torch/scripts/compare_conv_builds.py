"""Time builds of the conv kernels' sources against each other on one card.

    python -m im2im_uq_tpu_torch.scripts.compare_conv_builds [DIR ...] [--gemm-stem]

Run from the repository root: the shapes, inputs and bars are
``chip_smoke.py``'s. Each DIR (default: the package's ``csrc``) holds
``conv3x3.cu``, ``dgrad3x3.cu``, ``errors.cu`` and the headers they include,
for example ``im2im_uq_tpu_torch/csrc`` of another checkout. Each is built
by its own ``nvcc`` into ``build/im2im_uq_tpu_torch/compare/<i>/`` and bound
like the package's library. ``--gemm-stem`` adds a build of the first DIR
in which K3 and K4 take Cin = 1 through the shared GEMM: ``conv3x3.cu``'s
``cin == 1`` dispatch to the stem kernel is cut out of a copy.

Every build is held to the plain versions at a few shapes (``CONV_TOL``,
``SUM_TOL``, the same bits twice, K4's y the same with and without the
stats), then K3, K4 and K6 are timed with CUDA events (10 calls after 2
warm-ups) at the stem and at every conv shape of the batch-32 320x320
``pallas_fused`` step, the builds in turns (forward, backward, forward),
TF32 off. Prints the card's name and power limit, one JSON line per shape
with each build's mean ms, and one with each build's sums over the step's
launches. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.ops import conv, conv_bwd
from im2im_uq_tpu_torch.utils.timing import time_ms

__all__ = ["gemm_stem_source", "main"]

_SOURCES = ("conv3x3.cu", "dgrad3x3.cu", "errors.cu")
_ENTRIES = ("im2im_conv3x3_fused", "im2im_conv3x3_scratch", "im2im_dgrad3x3",
            "im2im_dgrad3x3_scratch")
_CHECK_SHAPES = [(1, 3, 5, 7, 16), (2, 64, 13, 17, 24), (2, 1, 1, 1, 8), (1, 1, 13, 17, 64),
                 (2, 256, 40, 40, 512), (1, 128, 160, 160, 128)]
_STEM = (32, 1, 320, 320, 64)
_STEM_DISPATCH = re.compile(r"\n  if \(cin == 1\) \{\n.*?\n  \}\n", re.S)


def gemm_stem_source(text: str) -> str:
    """``conv3x3.cu`` with its ``cin == 1`` dispatch to the stem kernel cut
    out, so that Cin = 1 runs through the shared GEMM."""
    out, n = _STEM_DISPATCH.subn("\n", text)
    if n != 1:
        raise ValueError(f"expected one `if (cin == 1)` block in conv3x3.cu, found {n}")
    return out


def _build_all(builds: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, src in builds.items():
        out = src / "lib.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(out),
               *[str(src / f) for f in _SOURCES]]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"build {name} failed:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(builds[name] / "lib.so"))
        for entry in _ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
        libs[name] = lib
    return libs


def _fwd(lib, c: dict, prologue: bool, stats: bool):
    x, w = c["x"], c["w"]
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    y = torch.empty((b, cout, h, wd), device="cuda")
    st = torch.zeros((b, 2, cout), device="cuda")
    part = torch.empty((lib.im2im_conv3x3_scratch(b, cout, h, wd),), device="cuda")
    _build.check(lib.im2im_conv3x3_fused(
        x.data_ptr(), w.data_ptr(), c["bias"].data_ptr(), c["scale"].data_ptr(),
        c["shift"].data_ptr(), y.data_ptr(), part.data_ptr(), st.data_ptr(), None, b, cin, cout,
        h, wd, int(prologue), int(stats), 0, x.device.index,
        torch.cuda.current_stream().cuda_stream),
        "conv3x3")
    return y, st


def _dgrad(lib, c: dict, prologue: bool):
    g, x, w = c["g"], c["x"], c["w"]
    b, cout, h, wd = g.shape
    cin = w.shape[1]
    dx = torch.empty((b, cin, h, wd), device="cuda")
    red = torch.zeros((2, cin), device="cuda")
    part = torch.empty((max(1, lib.im2im_dgrad3x3_scratch(b, cin, h, wd)),), device="cuda")
    _build.check(lib.im2im_dgrad3x3(
        g.data_ptr(), w.data_ptr(), x.data_ptr(), c["scale"].data_ptr(), c["shift"].data_ptr(),
        dx.data_ptr(), part.data_ptr(), red.data_ptr(), None, b, cin, cout, h, wd,
        int(prologue), 0, x.device.index, torch.cuda.current_stream().cuda_stream), "dgrad3x3")
    return dx, red


def _check(libs: dict, gen: torch.Generator) -> None:
    for shape in _CHECK_SHAPES:
        c = cs._conv_case(*shape, gen)
        for prologue in (True, False):
            want = conv.conv3x3_bn_act_plain(c["x"], c["w"], c["bias"], c["scale"], c["shift"],
                                             prologue, True)
            want_d = conv_bwd.dgrad3x3_plain(c["g"], c["x"], c["w"], c["scale"], c["shift"],
                                             prologue)
            bars = [cs.CONV_TOL, cs.SUM_TOL, cs.CONV_TOL] + [cs.SUM_TOL] * prologue
            for name, lib in libs.items():
                got, again = _fwd(lib, c, prologue, True), _fwd(lib, c, prologue, True)
                y_eval, _ = _fwd(lib, c, prologue, False)
                got_d, again_d = _dgrad(lib, c, prologue), _dgrad(lib, c, prologue)
                errs = [max(cs._conv_errors(a, b)[1:]) for a, b in zip(got + got_d, want + want_d)]
                same = (all(torch.equal(a, b) for a, b in zip(got + got_d, again + again_d))
                        and torch.equal(y_eval, got[0]))
                if not same or any(e > bar for e, bar in zip(errs, bars)):
                    raise AssertionError(f"build {name} at {shape} prologue={prologue}: "
                                         f"errors {errs}, the same bits twice: {same}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", type=Path, default=[_build.CSRC])
    ap.add_argument("--gemm-stem", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_conv_builds needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    root = _build.BUILD_ROOT / "compare"
    shutil.rmtree(root, ignore_errors=True)
    builds = {}
    for i, src in enumerate(args.dirs):
        variants = {str(src): None}
        if args.gemm_stem and i == 0:
            variants[f"{src} (gemm stem)"] = gemm_stem_source
        for name, edit in variants.items():
            dst = root / str(len(builds))
            shutil.copytree(src, dst)
            if edit is not None:
                (dst / "conv3x3.cu").write_text(edit((dst / "conv3x3.cu").read_text()))
            builds[name] = dst
    libs = _build_all(builds)
    gen = torch.Generator(device="cuda").manual_seed(7)
    _check(libs, gen)

    sites = cs.conv_sites("pallas_fused")
    cases = [("k3", _STEM, False, 0)]  # the stem of the `pallas` step
    for kernel, key in (("k4", "conv3x3_bn_act"), ("k3", "conv3x3"), ("k6", "dgrad3x3")):
        cases += [(kernel, shape, p, n)
                  for (shape, p), n in collections.Counter(sites[key]).items()]
    sums = {name: collections.Counter() for name in libs}
    for kernel, shape, prologue, n in cases:
        c = cs._conv_case(*shape, gen)
        calls = {name: ((lambda lib=lib: _dgrad(lib, c, prologue)) if kernel == "k6" else
                        (lambda lib=lib: _fwd(lib, c, prologue, kernel == "k4")))
                 for name, lib in libs.items()}
        times = collections.defaultdict(list)
        for name in [*calls, *reversed(calls), *calls]:
            times[name].append(time_ms(calls[name], 10))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        for name in ms:
            sums[name][kernel] += n * ms[name]
        print(json.dumps({"kernel": kernel, "shape": list(shape), "prologue": prologue,
                          "launches_per_step": n, "ms": ms}), flush=True)
        del c
    print(json.dumps({"ms_per_pallas_fused_step": sums}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
