"""Port parity: P1 (per-channel moments) and P2-P5 (the bias-free NHWC 3×3
conv), the ports of the Pallas probes of ``benchmarks/``, and their CLIs.

- P1: ``moments_plain`` against the probe's ``pallas_moments`` (Pallas in
  interpret mode, by wrapping ``pl.pallas_call`` of the probe's module)
  and its ``xla_moments``, f32 and bf16, x = N(3, 1) so that Σx²/n − mean²
  cancels, at (2, 16, 16, 64) and at row counts that are not a multiple of
  ``tile_rows`` (the probe zero-pads its last tile). Tolerances: the mean
  within 1e-5, the variance within 1e-4·E[x²] (f32 sums over the rows in
  another order).
- P2-P5: ``conv3x3_nobias_plain`` against each probe in interpret mode:
  P2/P3 at (1, 8, 8, 128→128), P4 at Cin 3 and 64 with H = 13 (its padded,
  cropped row tiles), P5 at (2, 16, 16, 64→32). f32 at rtol = atol = 2e-5
  (the probe's own bar, ``bench_pallas_conv.py:399``); bf16 within one bf16
  ulp of the probe's output (both sum exact bf16 products in f32 and round
  once).
- Dispatch: CPU tensors run the plain versions and count no launch; meta
  tensors raise; ``conv3x3_c64`` takes Cin = 64 only and P2/P3 whole
  chunks of channels; both CLIs run with ``--device cpu`` at a tiny size
  and raise, rather than fall back, when no CUDA device is seen.

Importing the moments probe calls ``enable_compilation_cache()``, which
sets JAX's global cache directory: the fixture points it at a temporary
directory and restores both settings afterwards.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im2im_uq_tpu_torch.ops import conv_probe, moments
from im2im_uq_tpu_torch.scripts import bench_conv3x3, bench_moments
from im2im_uq_tpu_torch.utils.timing import time_ms
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"
MEAN_ATOL, VAR_TOL = 1e-5, 1e-4
CONV_TOL = 2e-5
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", BENCHMARKS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jmoments(tmp_path_factory):
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IM2IM_UQ_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
        module = _load("bench_moments")
    try:
        yield module
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module")
def jconv():
    return _load("bench_pallas_conv")


def _jdtype(dtype: torch.dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


# --------------------------------------------------------------------- P1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tile_rows", [((2, 16, 16, 64), 2048), ((3, 7, 11, 64), 64),
                                             ((3, 7, 11, 3), 64)],
                         ids=["probe-tile", "ragged-tiles", "c3"])
def test_moments_plain_matches_the_pallas_probe(jmoments, monkeypatch, dtype, shape, tile_rows):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) + 3.0
    xj = jnp.asarray(x, _jdtype(dtype))
    monkeypatch.setattr(jmoments.pl, "pallas_call",
                        functools.partial(jmoments.pl.pallas_call, interpret=True))
    probe = [_np(a) for a in jmoments.pallas_moments(xj, tile_rows=tile_rows)]
    xla = [_np(a) for a in jmoments.xla_moments(xj)]
    mean, var = (t.numpy() for t in moments.moments_plain(torch.from_numpy(x).to(dtype)))
    ex2 = float((np.asarray(xj, np.float32) ** 2).mean())
    for want in (probe, xla):
        np.testing.assert_allclose(mean, want[0], rtol=0, atol=MEAN_ATOL)
        np.testing.assert_allclose(var, want[1], rtol=0, atol=VAR_TOL * ex2)


def test_moments_sums_and_finish():
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 5, 4).astype(np.float32))
    sums = moments.moment_sums(x)
    flat = x.reshape(-1, 4).double()
    # f32 sums of 30 terms of |x| ≲ 3: a few ulps of Σ|x| ≈ 25
    np.testing.assert_allclose(sums.numpy(), torch.stack([flat.sum(0), (flat ** 2).sum(0)]).numpy(),
                               rtol=1e-6, atol=1e-5)
    mean, var = moments.finish(sums, 30)
    np.testing.assert_allclose(mean.numpy(), flat.mean(0).numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(var.numpy(), flat.var(0, unbiased=False).numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ P2-P5

CONV_CASES = [  # (probe, Pallas function, (B, H, W, Cin, Cout))
    ("P2", "conv3x3_pallas", (1, 8, 8, 128, 128)),
    ("P3", "conv3x3_pallas_db", (1, 8, 8, 128, 128)),
    ("P4", "conv3x3_pallas_l1", (2, 13, 16, 3, 16)),
    ("P4", "conv3x3_pallas_l1", (2, 13, 16, 64, 32)),
    ("P5", "conv3x3_pallas_c64", (2, 16, 16, 64, 32)),
]


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    _, exp = np.frexp(a.astype(np.float32))
    return np.ldexp(np.ones_like(a, np.float32), exp - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("probe,pallas_fn,shape", CONV_CASES,
                         ids=[f"{c[0]}-cin{c[2][3]}" for c in CONV_CASES])
def test_conv_plain_matches_the_pallas_probe(jconv, probe, pallas_fn, shape, dtype):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (0.1 * rng.randn(3, 3, cin, cout)).astype(np.float32)
    jd = _jdtype(dtype)
    want = _np(getattr(jconv, pallas_fn)(jnp.asarray(x, jd), jnp.asarray(k, jd), interpret=True))
    xt, kt = torch.from_numpy(x).to(dtype), torch.from_numpy(k).to(dtype)
    plain = conv_probe.conv3x3_nobias_plain(xt, kt)
    wrapped = conv_probe.VARIANTS[probe](xt, kt)
    assert plain.dtype == dtype and tuple(plain.shape) == (b, h, w, cout)
    assert torch.equal(wrapped, plain)
    got = plain.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=CONV_TOL, atol=CONV_TOL)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


# ---------------------------------------------------------------- dispatch


def _conv_inputs(cin=64, device="cpu"):
    return (torch.zeros((1, 3, 5, cin), device=device), torch.zeros((3, 3, cin, 8), device=device))


@pytest.mark.parametrize("name", ["moments", "P2", "P3", "P4", "P5"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(name):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 5, 6, 64).astype(np.float32))
    if name == "moments":
        before = moments.moments.launches
        got = moments.moments(x)
        for a, b in zip(got, moments.moments_plain(x)):
            assert torch.equal(a, b)
        assert moments.moments.launches == before
        return
    fn = conv_probe.VARIANTS[name]
    k = torch.from_numpy(rng.randn(3, 3, 64, 8).astype(np.float32))
    before = (fn.launches, fn.f32.launches)
    assert torch.equal(fn(x, k), conv_probe.conv3x3_nobias_plain(x, k))
    assert (fn.launches, fn.f32.launches) == before


@pytest.mark.parametrize("name", ["moments", "P2", "P3", "P4", "P5"])
def test_meta_tensors_raise(name):
    x, k = _conv_inputs(device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        if name == "moments":
            moments.moments(x)
        else:
            conv_probe.VARIANTS[name](x, k)


def test_channel_gates():
    with pytest.raises(ValueError, match="Cin = 64"):
        conv_probe.conv3x3_c64(*_conv_inputs(cin=32))
    for fn in (conv_probe.conv3x3_single, conv_probe.conv3x3_db):
        with pytest.raises(ValueError, match="conv3x3_l1 takes any Cin"):
            fn(*_conv_inputs(cin=3))
    assert conv_probe.conv3x3_l1(*_conv_inputs(cin=3)).shape == (1, 3, 5, 8)
    assert [conv_probe.takes(p, 48, torch.bfloat16) for p in ("P2", "P3", "P4", "P5")] == [
        False, False, True, False]
    assert [conv_probe.takes(p, 48, torch.float32) for p in ("P2", "P3", "P4", "P5")] == [
        True, True, True, False]
    assert bench_conv3x3.variants_for(256) == ["P2", "P3"]
    assert bench_conv3x3.variants_for(64) == ["P5"]
    assert bench_conv3x3.variants_for(96) == ["P4"]


def test_bf16_tolerance_is_one_ulp_away_from_zero():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 4, 4, 8).astype(np.float32)).bfloat16()
    k = torch.from_numpy(0.1 * rng.randn(3, 3, 8, 4).astype(np.float32)).bfloat16()
    want = conv_probe.conv3x3_nobias_plain(x, k)
    tol = conv_probe.bf16_tolerance(x, k, want)
    ulp = torch.from_numpy(_bf16_ulp(want.float().numpy()))
    assert (tol >= ulp).all() and (tol <= ulp + 1e-4).all()


def test_bf16_ulp_matches_the_numpy_ulp():
    rng = np.random.RandomState(4)
    a = (rng.randn(512) * 10.0 ** rng.randint(-6, 7, 512)).astype(np.float32)
    np.testing.assert_array_equal(conv_probe.bf16_ulp(torch.from_numpy(a)).numpy(), _bf16_ulp(a))


def test_time_ms_uses_the_host_clock_off_the_card():
    calls = []
    ms = time_ms(lambda: calls.append(None), 5, torch.device("cpu"))
    assert len(calls) == 2 + 5 and ms >= 0.0


def test_cli_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    for name, size in zip("BHWC", (2, 4, 4, 3)):
        monkeypatch.setattr(bench_moments, name, size)
    assert bench_moments.main(["--device", "cpu"]) == 0
    assert bench_conv3x3.main(["1", "6", "96", "8", "--device", "cpu"]) == 0
    assert bench_conv3x3.main(["1", "6", "64", "8", "--device", "cpu", "--check"]) == 0
    out = capsys.readouterr().out
    assert "kernel moments" in out and "P4 conv3x3_l1" in out and "library F.conv2d" in out
    assert "parity OK (P5 conv3x3_c64)" in out


@pytest.mark.parametrize("cli", [bench_moments, bench_conv3x3], ids=["moments", "conv3x3"])
def test_cli_never_falls_back_to_the_cpu(monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
