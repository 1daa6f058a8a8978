"""Time builds of the conv kernels' sources against each other on one card.

    python -m im2im_uq_tpu_torch.scripts.compare_conv_builds [DIR ...] [--gemm-stem]

Run from the repository root: the shapes, inputs and bars are
``chip_smoke.py``'s. Each DIR (default: the package's ``csrc``) holds the
K3-K6 sources (``conv3x3.cu``, ``wgrad3x3.cu``, ``dgrad3x3.cu``, the bf16
kernels' ``conv3x3_bf16.cu``, before it ``conv3x3_bwd_bf16.cu``,
``errors.cu`` and the headers they include), for example
``im2im_uq_tpu_torch/csrc`` of another checkout unpacked with ``git
archive <commit> im2im_uq_tpu_torch/csrc | tar -x -C DIR``. Each is built
by its own ``nvcc`` into ``build/im2im_uq_tpu_torch/compare/<i>/`` and
bound like the package's library. Older sources are bound with their own
signatures: a build whose bf16 K3/K4 packs channel-pair words (it exports
``im2im_conv3x3_packed_words``) runs them through ``im2im_conv3x3_fused``
with the dtype argument 1 and its packed scratch; a build of the sources
before the bf16 K5/K6 redesign (it exports ``im2im_wgrad3x3_packed_words``)
runs K5/K6 in bf16 through its own entry points (the dtype argument 1, its
packing passes inside), the cotangent with the stats' terms in PyTorch ops
beside it. Newer builds run the bf16 kernels through the package's
wrappers, their operand passes and weight packing included.
``--gemm-stem`` adds a build of the first DIR in which K3 and K4 take Cin
= 1 through the shared GEMM: ``conv3x3.cu``'s ``cin == 1`` dispatch to the
stem kernel is cut out of a copy.

Every build is held to the plain versions at a few shapes (f32: ``CONV_TOL``,
``SUM_TOL``, K4's y the same with and without the stats; bf16 K3/K4: y and
the stats within ``chip_smoke.k34_bf16_over``'s bars; bf16 K5/K6: dW, db
and the reductions within ``SUM_TOL``, dx within 1e-2 relative L2; the same
bits twice), and each build's f32 K3-K6 outputs to the first build's, bit
for bit (K3/K4 at Cin = 1 not for the ``--gemm-stem`` build). Then, with CUDA events (10 calls after 2 warm-ups), the builds in
turns (forward, backward, forward), TF32 off: K3, K4, K5 and K6 in f32 at
the stem and at every conv shape of the batch-32 320x320 ``pallas_fused``
step; K3 in bf16 at every launch of the bf16 ``pallas`` step and of the
bf16 ``pallas_fused`` eval forward, K4 in bf16 (without the stats, as
serving runs it) at every launch of that eval forward; K5, K6 and the
cotangent in bf16 at every launch of the bf16 ``pallas_fused`` step.
Prints the card's name and power limit, one JSON line per shape with each
build's mean ms, and one with each build's sums over the paths' launches
(``k3_bf16``: per bf16 ``pallas`` step; ``k3_bf16_fused_eval`` and
``k4_bf16``: per bf16 ``pallas_fused`` eval forward; the rest per
``pallas_fused`` step). Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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

_SOURCES = ("conv3x3.cu", "wgrad3x3.cu", "dgrad3x3.cu", "conv3x3_bf16.cu", "conv3x3_bwd_bf16.cu",
            "errors.cu")
_P = ctypes.c_void_p
# the K5/K6 entry points before the bf16 redesign: a packed-operand scratch
# and a dtype code (0 float32, 1 bfloat16)
_PACKED_SIGNATURES = {
    "im2im_wgrad3x3": ([_P] * 8 + [ctypes.c_int] * 8 + [_P], ctypes.c_int),
    "im2im_wgrad3x3_packed_words": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "im2im_dgrad3x3": ([_P] * 9 + [ctypes.c_int] * 8 + [_P], ctypes.c_int),
    "im2im_dgrad3x3_packed_words": ([ctypes.c_int] * 5, ctypes.c_longlong),
}
# the K3/K4 entry points while bf16 K3/K4 packed channel-pair words: a
# packed-operand scratch after the stats
_PAIR_SIGNATURES = {
    "im2im_conv3x3_fused": ([_P] * 9 + [ctypes.c_int] * 9 + [_P], ctypes.c_int),
    "im2im_conv3x3_packed_words": ([ctypes.c_int] * 5, ctypes.c_longlong),
}
_CHECK_SHAPES = [(1, 3, 5, 7, 16), (2, 64, 13, 17, 24), (2, 1, 1, 1, 8), (1, 1, 13, 17, 64),
                 (2, 256, 40, 40, 512), (1, 128, 160, 160, 128)]
_STEM = (32, 1, 320, 320, 64)
_STEM_DISPATCH = re.compile(r"\n  if \(cin == 1\) \{\n.*?\n  \}\n", re.S)
B16 = torch.bfloat16


def gemm_stem_source(text: str) -> str:
    """``conv3x3.cu`` with its ``cin == 1`` dispatch to the stem kernel cut
    out, so that Cin = 1 runs through the shared GEMM."""
    out, n = _STEM_DISPATCH.subn("\n", text)
    if n != 1:
        raise ValueError(f"expected one `if (cin == 1)` block in conv3x3.cu, found {n}")
    return out


class Build:
    """One build's library, bound with its own signatures; ``packed``: the
    sources before the bf16 K5/K6 redesign; ``pairs``: before the bf16
    K3/K4 redesign; ``stem`` False for the ``--gemm-stem`` build, which
    runs f32 K3/K4 at Cin = 1 through the GEMM and bf16 there not at all."""

    def __init__(self, path: Path, stem: bool = True):
        self.lib = ctypes.CDLL(str(path))
        self.stem = stem
        self.packed = hasattr(self.lib, "im2im_wgrad3x3_packed_words")
        self.pairs = hasattr(self.lib, "im2im_conv3x3_packed_words")
        signatures = dict(_build._SIGNATURES, **(_PACKED_SIGNATURES if self.packed else {}),
                          **(_PAIR_SIGNATURES if self.pairs else {}))
        for entry, (argtypes, restype) in signatures.items():
            if hasattr(self.lib, entry):
                fn = getattr(self.lib, entry)
                fn.argtypes, fn.restype = argtypes, restype

    @contextlib.contextmanager
    def bound(self):
        """The package's wrappers launch this build's kernels."""
        saved = _build.library
        _build.library = lambda: self.lib
        try:
            yield
        finally:
            _build.library = saved


def _build_all(builds: dict[str, Path], gemm_stem: set[str],
               sources: tuple[str, ...] = _SOURCES) -> dict[str, Build]:
    """Each directory's ``sources`` (those it has) into its own library, all
    nvcc processes at once."""
    procs = {}
    for name, src in builds.items():
        out = src / "lib.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I", str(src), "-o", str(out),
               *[str(src / f) for f in sources if (src / f).exists()]]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"build {name} failed:\n{log[-3000:]}")
        libs[name] = Build(builds[name] / "lib.so", stem=name not in gemm_stem)
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _fwd(bd: Build, c: dict, prologue: bool, stats: bool, bf16: bool = False):
    """K4 (K3: neither the prologue nor the stats) in f32, or in bf16 on the
    bf16 inputs ``c``."""
    x, w = c["x"], c["w"]
    if bf16 and not bd.pairs:
        with bd.bound():
            return conv.conv3x3_bn_act_fwd(x, w, c["bias"], c["scale"], c["shift"], prologue,
                                           stats)
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    y = torch.empty((b, cout, h, wd), dtype=x.dtype, device="cuda")
    st = torch.zeros((b, 2, cout), device="cuda")
    part = torch.empty((bd.lib.im2im_conv3x3_scratch(b, cout, h, wd),), device="cuda")
    ptrs = [x.data_ptr(), w.data_ptr(), c["bias"].data_ptr(), c["scale"].data_ptr(),
            c["shift"].data_ptr(), y.data_ptr(), part.data_ptr(), st.data_ptr()]
    if bd.pairs:  # the packed scratch (bf16 beyond the stem only)
        words = bd.lib.im2im_conv3x3_packed_words(b, cin, cout, h, wd) if bf16 else 0
        scratch = torch.empty((words,), dtype=torch.int32, device="cuda") if words else None
        ptrs.append(scratch.data_ptr() if words else None)
    _build.check(bd.lib.im2im_conv3x3_fused(
        *ptrs, b, cin, cout, h, wd, int(prologue), int(stats), int(bf16), x.device.index,
        _stream()), "conv3x3")
    return y, st


def _wgrad(bd: Build, c: dict, prologue: bool, bf16: bool = False):
    """K5 in f32, or in bf16 with c["gp"] the NHWC cotangent (new builds)."""
    x, g = c["x"], c["g"]
    b, cin, h, wd = x.shape
    cout = g.shape[1]
    if bf16 and not bd.packed:
        with bd.bound():
            return conv_bwd.wgrad3x3_nhwc(x, c["gp"], cout, c["scale"], c["shift"], prologue)
    dw = torch.empty((cout, cin, 3, 3), device="cuda")
    db = torch.empty((cout,), device="cuda")
    part = torch.empty((bd.lib.im2im_wgrad3x3_scratch(b, cin, cout, h, wd),), device="cuda")
    ptrs = [x.data_ptr(), g.data_ptr(), c["scale"].data_ptr(), c["shift"].data_ptr(),
            part.data_ptr()]
    ints = [b, cin, cout, h, wd, int(prologue)]
    if bd.packed:  # the packed scratch (bf16 only) and the dtype code
        words = bd.lib.im2im_wgrad3x3_packed_words(b, cin, cout, h, wd)
        scratch = torch.empty((words,), dtype=torch.int32, device="cuda") if bf16 else None
        ptrs.append(scratch.data_ptr() if bf16 else None)
        ints.append(int(bf16))
    _build.check(bd.lib.im2im_wgrad3x3(*ptrs, dw.data_ptr(), db.data_ptr(), *ints,
                                       x.device.index, _stream()), "wgrad3x3")
    return dw, db


def _dgrad(bd: Build, c: dict, prologue: bool, bf16: bool = False):
    """K6 in f32, or in bf16 with c["gp"] the NHWC cotangent (new builds)."""
    g, x, w = c["g"], c["x"], c["w"]
    b, cout, h, wd = g.shape
    cin = w.shape[1]
    if bf16 and not bd.packed:
        with bd.bound():
            return conv_bwd.dgrad3x3_nhwc(c["gp"], x, w, c["scale"], c["shift"], prologue)
    dx = torch.empty_like(x)
    red = torch.zeros((2, cin), device="cuda")
    part = torch.empty((max(1, bd.lib.im2im_dgrad3x3_scratch(b, cin, h, wd)),), device="cuda")
    ptrs = [g.data_ptr(), w.data_ptr(), x.data_ptr(), c["scale"].data_ptr(),
            c["shift"].data_ptr(), dx.data_ptr(), part.data_ptr(), red.data_ptr()]
    ints = [b, cin, cout, h, wd, int(prologue)]
    if bd.packed:  # the packed scratch (bf16 only) and the dtype code
        words = bd.lib.im2im_dgrad3x3_packed_words(b, cin, cout, h, wd)
        scratch = torch.empty((words,), dtype=torch.int32, device="cuda") if bf16 else None
        ptrs.append(scratch.data_ptr() if bf16 else None)
        ints.append(int(bf16))
    _build.check(bd.lib.im2im_dgrad3x3(*ptrs, *ints, x.device.index, _stream()), "dgrad3x3")
    return dx, red


def _cotangent(bd: Build, c: dict):
    """The bf16 cotangent with the stats' terms: the cotangent pass (new
    builds) or the PyTorch ops before it."""
    if bd.packed:
        return conv_bwd.cotangent_plain(c["g"], c["y"], c["gst"])
    with bd.bound():
        return conv_bwd.cotangent_nhwc(c["g"], c["y"], c["gst"])


def _bf16_case(shape: tuple, gen: torch.Generator) -> dict:
    c = cs._conv_case(*shape, gen)
    c = dict(c, **{k: c[k].to(B16) for k in ("x", "g", "w", "bias")})
    c["y"] = torch.randn(c["g"].shape, generator=gen, device="cuda").to(B16)
    c["gst"] = 1e-2 * torch.randn((shape[0], 2, shape[4]), generator=gen, device="cuda")
    c["gp"] = conv_bwd.to_nhwc(c["g"])
    return c


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return max(cs._conv_errors(a, b)[1:])


def _check(libs: dict, gen: torch.Generator) -> None:
    for shape in _CHECK_SHAPES:
        c = cs._conv_case(*shape, gen)
        cb = _bf16_case(shape, gen)
        for prologue in (True, False):
            want = conv.conv3x3_bn_act_plain(c["x"], c["w"], c["bias"], c["scale"], c["shift"],
                                             prologue, True)
            want_d = conv_bwd.dgrad3x3_plain(c["g"], c["x"], c["w"], c["scale"], c["shift"],
                                             prologue)
            want_w = conv_bwd.wgrad3x3_plain(c["x"], c["g"], c["scale"], c["shift"], prologue)
            want_bw = conv_bwd.wgrad3x3_plain(cb["x"], cb["g"], cb["scale"], cb["shift"], prologue)
            want_bd = conv_bwd.dgrad3x3_plain(cb["g"], cb["x"], cb["w"], cb["scale"], cb["shift"],
                                              prologue)
            want_by = conv.conv3x3_bn_act_plain(cb["x"], cb["w"], cb["bias"], cb["scale"],
                                                cb["shift"], prologue, True)
            act = conv_bwd.prologue_activation(cb["x"].float(), cb["scale"], cb["shift"],
                                               prologue).to(B16)
            first_f32 = None
            for name, bd in libs.items():
                k34 = bd.stem or shape[1] > 1  # K3/K4 on the kernels of the first build
                runs = [lambda: _fwd(bd, c, prologue, True) + _dgrad(bd, c, prologue)
                        + _wgrad(bd, c, prologue),
                        lambda: _wgrad(bd, cb, prologue, True) + _dgrad(bd, cb, prologue, True)
                        + (_fwd(bd, cb, prologue, True, True) if k34 else ())]
                got, again = runs[0](), runs[0]()
                y_eval, _ = _fwd(bd, c, prologue, False)
                bgot, bagain = runs[1](), runs[1]()
                errs = [_rel(a, b) for a, b in zip(got, want + want_d + want_w)]
                bars = [cs.CONV_TOL, cs.SUM_TOL, cs.CONV_TOL, cs.SUM_TOL, cs.SUM_TOL, cs.SUM_TOL]
                errs += [_rel(bgot[0], want_bw[0]), _rel(bgot[1], want_bw[1]),
                         float((bgot[2].float() - want_bd[0].float()).norm()
                               / want_bd[0].float().norm().clamp_min(1e-30)),
                         _rel(bgot[3], want_bd[1])]
                bars += [cs.SUM_TOL, cs.SUM_TOL, 1e-2, cs.SUM_TOL]
                k34_over = cs.k34_bf16_over(bgot[4:], want_by, act, cb["w"]) if k34 else ()
                same = (all(torch.equal(a, b) for a, b in zip(got + bgot, again + bagain))
                        and torch.equal(y_eval, got[0])
                        and (not k34 or torch.equal(_fwd(bd, cb, prologue, False, True)[0],
                                                    bgot[4])))
                if first_f32 is None:
                    first_f32 = got
                same_f32 = all(torch.equal(a, b) for a, b in zip(got[0 if k34 else 2:],
                                                               first_f32[0 if k34 else 2:]))
                if (not same or not same_f32 or any(k34_over)
                        or any(e > bar for e, bar in zip(errs, bars))):
                    raise AssertionError(f"build {name} at {shape} prologue={prologue}: errors "
                                         f"{errs} (bars {bars}), bf16 K3/K4 outputs over their "
                                         f"bars {k34_over}, the same bits twice: {same}, f32 "
                                         f"K3-K6 as the first build's: {same_f32}")


def _cases() -> list:
    """(kernel, shape, prologue, {sum: launches}) of every timed case: the
    launches per ``pallas_fused`` step (f32; K5, K6 and the cotangent in
    bf16), per bf16 ``pallas`` step (``k3_bf16``) and per bf16
    ``pallas_fused`` eval forward (``k3_bf16_fused_eval``, ``k4_bf16``)."""
    sites = cs.conv_sites("pallas_fused")
    cases = [("k3", _STEM, False, {})]  # the stem of the `pallas` step
    for kernel, key in (("k4", "conv3x3_bn_act"), ("k3", "conv3x3"), ("k5", "wgrad3x3"),
                        ("k6", "dgrad3x3")):
        cases += [(kernel, shape, p, {kernel: n})
                  for (shape, p), n in collections.Counter(sites[key]).items()]
    bf16 = cs.bf16_conv_sites()
    k3 = bf16["conv3x3_bf16"]
    for shape, p in dict.fromkeys([*k3["pallas"], *k3["pallas_fused"]]):
        counts = {"k3_bf16": k3["pallas"][(shape, p)],
                  "k3_bf16_fused_eval": k3["pallas_fused"][(shape, p)]}
        cases.append(("k3_bf16", shape, p, {k: n for k, n in counts.items() if n}))
    cases += [("k4_bf16", shape, p, {"k4_bf16": n})
              for (shape, p), n in bf16["conv3x3_bn_act_bf16"]["pallas_fused"].items()]
    for kernel, key in (("k5_bf16", "wgrad3x3"), ("k6_bf16", "dgrad3x3"),
                        ("cotangent_bf16", "conv3x3_bn_act")):
        cases += [(kernel, shape, p, {kernel: n})
                  for (shape, p), n in collections.Counter(sites[key]).items()]
    return cases


def _call(kernel: str, bd: Build, c: dict, prologue: bool):
    if kernel in ("k3", "k4"):
        return lambda: _fwd(bd, c, prologue, kernel == "k4")
    if kernel in ("k3_bf16", "k4_bf16"):
        return lambda: _fwd(bd, c, prologue, False, True)
    if kernel == "cotangent_bf16":
        return lambda: _cotangent(bd, c)
    fn = _wgrad if kernel.startswith("k5") else _dgrad
    return lambda: fn(bd, c, prologue, kernel.endswith("bf16"))


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
    builds, gemm_stem = {}, set()
    for i, src in enumerate(args.dirs):
        variants = {str(src): None}
        if args.gemm_stem and i == 0:
            variants[f"{src} (gemm stem)"] = gemm_stem_source
        for name, edit in variants.items():
            dst = root / str(len(builds))
            shutil.copytree(src, dst)
            if edit is not None:
                (dst / "conv3x3.cu").write_text(edit((dst / "conv3x3.cu").read_text()))
                gemm_stem.add(name)
            builds[name] = dst
    libs = _build_all(builds, gemm_stem)
    gen = torch.Generator(device="cuda").manual_seed(7)
    _check(libs, gen)

    sums = {name: collections.Counter() for name in libs}
    for kernel, shape, prologue, launches in _cases():
        c = (_bf16_case(shape, gen) if kernel.endswith("bf16")
             else cs._conv_case(*shape, gen))
        if kernel == "cotangent_bf16":  # (B, Cout, H, W) of the K4's output
            c["g"] = torch.randn((shape[0], shape[4], shape[2], shape[3]), generator=gen,
                                 device="cuda").to(B16)
            c["y"] = torch.randn_like(c["g"], dtype=torch.float32).to(B16)
        calls = {name: _call(kernel, bd, c, prologue) for name, bd in libs.items()
                 if bd.stem or shape[1] > 1 or kernel not in ("k3_bf16", "k4_bf16")}
        times = collections.defaultdict(list)
        for name in [*calls, *reversed(calls), *calls]:
            times[name].append(time_ms(calls[name], 10))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        for name in ms:
            for key, n in launches.items():
                sums[name][key] += n * ms[name]
        print(json.dumps({"kernel": kernel, "shape": list(shape), "prologue": prologue,
                          "launches": launches, "ms": ms}), flush=True)
        del c
    for name, s in sums.items():  # the bf16 backward of a step, the cotangent in
        s["k5_k6_cotangent_bf16"] = s["k5_bf16"] + s["k6_bf16"] + s["cotangent_bf16"]
    print(json.dumps({"ms_sums": sums}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
