"""Time builds of K1f's and K1b's sources against each other on one card.

    python -m im2im_uq_tpu_torch.scripts.compare_upsample_builds [DIR ...] [--sass]

Run from the repository root: the shapes and bars are ``chip_smoke.py``'s.
Each DIR (default: the package's ``csrc``) holds ``upsample2x.cu``,
``upsample2x_bwd.cu``, ``errors.cu`` and the headers they include, for
example ``im2im_uq_tpu_torch/csrc`` of another checkout unpacked with ``git
archive <commit> im2im_uq_tpu_torch/csrc | tar -x -C DIR``. Each is built
by its own ``nvcc`` into ``build/im2im_uq_tpu_torch/compare/<i>/`` (all at
once, ``compare_conv_builds._build_all``) and driven through the package's
wrappers (``compare_conv_builds.Build.bound``); the C entry points take the
same arguments in every build since the first, so an older build runs as
it ran then (its bf16 dtype code is the vector kind's, 1).

At every shape of ``chip_smoke.K1_STEP_SHAPES`` (the step's three K1
launches), in f32 and bf16, K1f and K1b of every build are held
to their plain versions (bf16: bit for bit; f32: ``chip_smoke``'s bars),
to themselves (the same bits twice) and to the first build's outputs, bit
for bit. Then, with CUDA events (20 calls after 2 warm-ups), the builds in
turns (first, second, second, first, first, second), each kernel and dtype
at each launched shape; a build that has the one-column instance (it
exports ``im2im_upsample2x_plan``) is timed on it too, through a view at an
odd element offset. Prints the card's name and power limit, one JSON line
per shape with each build's mean ms, and one with the sums over the three
launched shapes, beside the byte bound. ``--sass`` adds, per build, the
SASS instruction count of each K1 kernel (``cuobjdump -sass``) and its
calls (the 64-bit division routines are calls). Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from im2im_uq_tpu_torch import _build
from im2im_uq_tpu_torch.ops import upsample
from im2im_uq_tpu_torch.scripts.compare_conv_builds import Build, _build_all
from im2im_uq_tpu_torch.utils.timing import time_ms

__all__ = ["main", "sass_counts"]

_SOURCES = ("upsample2x.cu", "upsample2x_bwd.cu", "errors.cu")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(\S.*?);")


def sass_counts(text: str) -> dict[str, dict]:
    """``cuobjdump -sass`` output → {kernel: {"instructions": n, "calls": n}}
    for the K1 kernels (their mangled names hold ``upsample2x``)."""
    counts: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = m.group(1) if "upsample2x" in m.group(1) else None
            if name:
                counts[name] = {"instructions": 0, "calls": 0}
            continue
        m = _INSTRUCTION.match(line)
        if name and m and not m.group(1).startswith("NOP"):
            counts[name]["instructions"] += 1
            counts[name]["calls"] += m.group(1).lstrip("@!P0123456789T ").startswith("CALL")
    return counts


def _inputs(shape: tuple, dtype: torch.dtype, gen: torch.Generator) -> dict:
    b, c, h, w = shape
    return {"k1f": torch.randn(shape, generator=gen, device="cuda").to(dtype),
            "k1b": torch.randn((b, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)}


_KERNELS = {"k1f": (upsample.upsample2x_fwd, upsample.upsample2x_plain),
            "k1b": (upsample.upsample2x_bwd, upsample.upsample2x_bwd_plain)}


def _check(libs: dict[str, Build], gen: torch.Generator) -> None:
    for shape in cs.K1_STEP_SHAPES:
        for dname, dtype in _DTYPES.items():
            inputs = _inputs(shape, dtype, gen)
            for kernel, (fn, plain) in _KERNELS.items():
                t = inputs[kernel]
                want = plain(t)
                first = None
                for name, bd in libs.items():
                    with bd.bound():
                        got, again = fn(t), fn(t)
                    torch.cuda.synchronize()
                    if dtype == torch.bfloat16:
                        ok = torch.equal(cs.bits(got), cs.bits(want))
                    else:
                        bar = (1e-6 if kernel == "k1f" else 4e-6) * t.abs().max().item()
                        ok = (got - want).abs().max().item() <= bar
                    first = got if first is None else first
                    same = torch.equal(cs.bits(got), cs.bits(again))
                    as_first = torch.equal(cs.bits(got), cs.bits(first))
                    if not (ok and same and as_first):
                        raise AssertionError(
                            f"build {name}, {kernel} {dname} at {shape}: within its bar of the "
                            f"plain version {ok}, the same bits twice {same}, the first "
                            f"build's bits {as_first}")
                    print(json.dumps({"check": kernel, "dtype": dname, "shape": list(shape),
                                      "build": name, "plain": ok, "twice": same,
                                      "as_first_build": as_first}), flush=True)


def _sass(libs: dict[str, Build], paths: dict[str, Path]) -> None:
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in libs:
        out = subprocess.run([str(tool), "-sass", str(paths[name] / "lib.so")],
                             capture_output=True, text=True, check=True).stdout
        print(json.dumps({"sass": name, "kernels": sass_counts(out)}), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", type=Path, default=[_build.CSRC])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_upsample_builds needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    root = _build.BUILD_ROOT / "compare"
    shutil.rmtree(root, ignore_errors=True)
    builds = {}
    for src in args.dirs:
        dst = root / str(len(builds))
        shutil.copytree(src, dst)
        builds[str(src)] = dst
    libs = _build_all(builds, set(), _SOURCES)
    if args.sass:
        _sass(libs, builds)
    gen = torch.Generator(device="cuda").manual_seed(13)
    _check(libs, gen)

    sums = {name: collections.Counter() for name in libs}
    bound = collections.Counter()
    for shape in cs.K1_STEP_SHAPES:
        for dname, dtype in _DTYPES.items():
            inputs = _inputs(shape, dtype, gen)
            for kernel, (fn, _) in _KERNELS.items():
                t = inputs[kernel]
                key = f"{kernel}_{dname}"
                # x read and y written (K1f), g read and dx written (K1b)
                bound[key] += (1e3 * 5 * inputs["k1f"].numel() * t.element_size()
                               / cs.PEAK_BYTES_PER_S)

                def timed(bd, t=t, fn=fn):
                    with bd.bound():
                        return time_ms(lambda: fn(t), 20)
                times = collections.defaultdict(list)
                for name in [*libs, *reversed(libs), *libs]:
                    times[name].append(timed(libs[name]))
                ms = {name: sum(v) / len(v) for name, v in times.items()}
                if dtype == torch.bfloat16:
                    tu = cs.unaligned_copy(t)
                    for name, bd in libs.items():
                        if hasattr(bd.lib, "im2im_upsample2x_plan"):
                            one = f"{name} (one column a thread)"
                            ms[one] = timed(bd, tu)
                            sums[name][f"{key}_one_column"] += ms[one]
                for name in libs:
                    sums[name][key] += ms[name]
                print(json.dumps({"kernel": kernel, "dtype": dname, "shape": list(shape),
                                  "ms": ms}), flush=True)
    print(json.dumps({"ms_sums": sums, "bound_ms": bound,
                      "shapes": [list(s) for s in cs.K1_STEP_SHAPES]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
