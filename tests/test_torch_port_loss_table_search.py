"""K2's algorithm, the per-pixel threshold search, modelled in numpy.

``csrc/loss_table.cu`` does not test every (pixel, λ) pair. It ranks the
grid (NaN last, ties by index), pads it with NaN to a power of two above
L, finds each pixel's interval of missed ranks by a fixed number of
halvings over the same f32 product and strict compare (a prefix for a
positive slope, a suffix for a negative one, the finite values for a
zero slope, nothing for a NaN slope), adds ±1 to a
difference array of L + 1 integer bins and takes their prefix sum, then
scatters the counts back to the grid's columns and divides by P in f32.
The kernel runs only on the card; :func:`search_table` takes the same
steps here, so that the monotonicity argument it stands on is pinned
where no card is present.

The model is held, with 0 differing cells, to ``loss_table_plain`` (the
port's plain version) and to the JAX package's ``loss_table_pallas`` in
interpret mode, as ``tests/test_pallas.py`` runs it, on grids that are
unsorted, hold duplicates, negative values, ±0, NaN and ±inf, on slopes of
both signs, ±0, ±inf and NaN, on exact ties λ·s == r, at P = 1 and L = 1,
and on random grids and maps (hypothesis). Shapes stay within one Pallas
block (N ≤ 8, P ≤ 2048, L ≤ 128), so the JAX kernel compiles once.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from im2im_uq_tpu.ops import sets as jsets
from im2im_uq_tpu.ops.pallas_kernels import loss_table_pallas

from im2im_uq_tpu_torch.ops import loss_table as tloss
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

EPS = np.float32(1e-6)  # COLLAPSE_EPS
INF = np.float32(np.inf)
NAN = np.float32(np.nan)


def rank_grid(lam: np.ndarray) -> np.ndarray:
    """rank[i] = #{j: key(j) < key(i)}, keys ordered NaN last, then by value
    (-0 == +0), ties by index: the kernel's rank by counting."""
    idx = np.arange(lam.size)
    isn = np.isnan(lam)
    vj, vi = lam[:, None], lam[None, :]
    nj, ni = isn[:, None], isn[None, :]
    with np.errstate(invalid="ignore"):
        by_value = np.where(vj != vi, vj < vi, idx[:, None] < idx[None, :])
    before = np.where(nj != ni, ni, np.where(ni, idx[:, None] < idx[None, :], by_value))
    return before.sum(axis=0)


def first_false(v: np.ndarray, length, pred) -> np.ndarray:
    """Per lane, the first index in [0, length) of the ascending ``v`` at
    which ``pred`` fails, by the kernel's halving loop."""
    base = np.zeros(np.shape(length), np.int64)
    ln = np.array(length, np.int64)
    while (ln > 0).any():
        half = ln >> 1
        active = ln > 0
        t = active & pred(v[np.where(active, base + half, 0)])
        base = np.where(t, base + half + 1, base)
        ln = np.where(active, np.where(t, ln - half - 1, half), 0)
    return base


def halving_search(v: np.ndarray, s: np.ndarray, r: np.ndarray, suffix: bool) -> np.ndarray:
    """Per pixel, the kernel's search: over v padded with NaN to p2 (a power
    of two above L), log2(p2) halvings, each adding ``half`` to k where the
    probe v[k + half - 1] passes: ``λ·s < r`` (a prefix), or for a suffix
    ``not λ·s < r`` at a number."""
    k = np.zeros(s.shape, np.int64)
    half = v.size >> 1
    while half > 0:
        x = v[k + half - 1]
        hit = x * s < r
        k += np.where((~hit & (x == x)) if suffix else hit, half, 0)
        half >>= 1
    return k


def search_table(pred, label, dl, du, lam) -> np.ndarray:
    """The (N, L) table by K2's steps, all in f32 except the integer counts."""
    pred, label, dl, du = (np.asarray(a, np.float32) for a in (pred, label, dl, du))
    lam = np.asarray(lam, np.float32)
    n, p = pred.shape
    num_lam = lam.size
    rank = rank_grid(lam)
    p2 = 1 << num_lam.bit_length()  # the power of two above L
    v = np.full(p2, NAN, np.float32)
    v[rank] = lam
    lv = int(first_false(v, num_lam, lambda x: x == x))
    f0 = int(first_false(v, lv, lambda x: x == -INF))
    f1 = int(first_false(v, lv, lambda x: x < INF))

    with np.errstate(invalid="ignore", over="ignore"):
        a = pred - label
        b = -a
        lo, hi = a > EPS, b > EPS
        s = np.where(lo, dl, du)
        r = np.where(lo, a, b)
        some = lo | hi
        rows = np.broadcast_to(np.arange(n)[:, None], (n, p))
        bins = np.zeros((n, num_lam + 1), np.int64)

        def search(mask, suffix):
            return rows[mask], halving_search(v, s[mask], r[mask], suffix)

        m, k = search(some & (s > 0), False)  # missed on [0, k)
        np.add.at(bins, (m, 0), 1)
        np.add.at(bins, (m, k), -1)
        m, k = search(some & (s < 0), True)  # missed on [k, lv)
        np.add.at(bins, (m, k), 1)
        np.add.at(bins, (m, lv), -1)
        zero = (some & (s == 0)).sum(axis=1)  # missed at every finite λ
        bins[:, f0] += zero
        bins[:, f1] -= zero
    cover = np.cumsum(bins[:, :num_lam], axis=1)
    return cover[:, rank].astype(np.float32) / np.float32(p)


def plain(maps, lam) -> np.ndarray:
    return tloss.loss_table_plain(*map(torch.from_numpy, maps), torch.from_numpy(lam)).numpy()


def pallas(maps, lam) -> np.ndarray:
    pred, label, dl, du = map(jnp.asarray, maps)
    return np.asarray(loss_table_pallas(jsets.IntervalParams(pred, dl, du), label,
                                        jnp.asarray(lam), interpret=True))


def _maps(seed: int, n: int, p: int, signed: bool = False, special: bool = False):
    """(pred, label, dl, du), f32: residuals of both signs, slopes in [0.05,
    0.5] (``signed``: of both signs); ``special``: ±0, ±inf and NaN slopes
    and residuals within the 1e-6 guard."""
    rng = np.random.RandomState(seed)
    pred = rng.rand(n, p).astype(np.float32)
    label = (pred + 0.3 * rng.randn(n, p)).astype(np.float32)
    dl, du = (0.05 + 0.45 * rng.rand(2, n, p)).astype(np.float32)
    if signed:
        dl *= np.where(rng.rand(n, p) < 0.5, -1, 1).astype(np.float32)
        du *= np.where(rng.rand(n, p) < 0.5, -1, 1).astype(np.float32)
    if special:
        for slope in (dl, du):
            pick = rng.randint(0, 6, size=(n, p))
            slope[pick == 0] = 0.0
            slope[pick == 1] = -0.0
            slope[pick == 2] = INF
            slope[pick == 3] = -INF
            slope[pick == 4] = NAN
        label[:, :1] = pred[:, :1] - np.float32(5e-7)  # within the guard
    return pred, label, dl, du


def _ties(n: int, p: int, lam: np.ndarray):
    """Maps whose residual equals λ·s exactly for a λ of the grid."""
    rng = np.random.RandomState(7)
    s = np.float32(0.5) + rng.randint(0, 8, size=(n, p)).astype(np.float32) / 16
    pick = lam[rng.randint(0, lam.size, size=(n, p))]
    r = np.abs(pick * s).astype(np.float32) + np.float32(0.0)
    sign = rng.rand(n, p) < 0.5  # the lower side (a = r) or the upper (b = r)
    label = np.zeros((n, p), np.float32)
    pred = np.where(sign, r, -r).astype(np.float32)
    return pred, label, s, s.copy()


def _grid(kind: str) -> np.ndarray:
    lin = np.linspace(0.0, 3.0, 97).astype(np.float32)
    rng = np.random.RandomState(11)
    grids = {
        "sorted": lin,
        "unsorted": rng.permutation(lin),
        "duplicates": rng.permutation(np.repeat(lin[::4], 4))[:97],
        "negative": rng.permutation(np.linspace(-3.0, 3.0, 101).astype(np.float32)),
        "signed_zeros": rng.permutation(np.concatenate(
            [lin[:40], np.float32([-0.0, 0.0, -0.0, 0.0])])),
        "nan_inf": rng.permutation(np.concatenate(
            [np.linspace(-2.0, 2.0, 60).astype(np.float32),
             np.float32([NAN, INF, -INF, NAN, INF, 0.0, -0.0])])),
        "one": np.float32([0.7]),
        "one_nan": np.float32([NAN]),
        "all_inf": np.float32([INF, -INF, INF]),
    }
    return grids[kind].astype(np.float32)


CASES = [
    # (grid, maps: seed, N, P, signed slopes, special values)
    ("sorted", (0, 3, 200, False, False)),
    ("unsorted", (1, 3, 200, False, False)),
    ("duplicates", (2, 2, 150, False, False)),
    ("negative", (3, 3, 130, True, False)),
    ("signed_zeros", (4, 2, 120, True, True)),
    ("nan_inf", (5, 4, 256, True, True)),
    ("nan_inf", (6, 1, 1, True, False)),  # P = 1
    ("one", (7, 5, 77, True, True)),  # L = 1
    ("one_nan", (8, 2, 33, False, False)),
    ("all_inf", (9, 2, 64, True, True)),
    ("negative", (10, 8, 2048, True, True)),  # one whole Pallas block
]


@pytest.mark.parametrize("grid,spec", CASES,
                         ids=[f"{g}-N{s[1]}-P{s[2]}" for g, s in CASES])
def test_search_model_matches_plain_and_pallas(grid, spec):
    seed, n, p, signed, special = spec
    lam = _grid(grid)
    maps = _maps(seed, n, p, signed, special)
    got = search_table(*maps, lam)
    np.testing.assert_array_equal(got, plain(maps, lam))
    np.testing.assert_array_equal(got, pallas(maps, lam))


@pytest.mark.parametrize("grid", ["sorted", "unsorted", "negative", "signed_zeros", "nan_inf"])
def test_search_model_on_exact_ties(grid):
    """r == fl(λ·s) for a λ of the grid: the strict compare misses there."""
    lam = _grid(grid)
    maps = _ties(3, 300, lam[np.isfinite(lam)])
    with np.errstate(invalid="ignore"):
        a = maps[0] - maps[1]
        assert (np.abs(a)[:, :, None] == np.abs(lam[None, None, :] * maps[2][:, :, None])).any(2).all()
    got = search_table(*maps, lam)
    np.testing.assert_array_equal(got, plain(maps, lam))
    np.testing.assert_array_equal(got, pallas(maps, lam))


def test_rank_is_a_permutation_with_nan_last_and_ties_by_index():
    lam = np.float32([2.0, NAN, -0.0, 0.0, -INF, 2.0, INF, NAN, -1.0])
    rank = rank_grid(lam)
    assert sorted(rank) == list(range(lam.size))
    order = np.argsort(rank)
    np.testing.assert_array_equal(order, [4, 8, 2, 3, 0, 5, 6, 1, 7])


_floats = st.floats(width=32, allow_nan=True, allow_infinity=True, allow_subnormal=False)


@settings(max_examples=40, deadline=None)
@given(
    lam=st.lists(_floats, min_size=1, max_size=40),
    seed=st.integers(0, 2**31 - 1),
    n=st.integers(1, 4),
    p=st.integers(1, 64),
    signed=st.booleans(),
    special=st.booleans(),
)
def test_search_model_matches_plain_on_random_grids(lam, seed, n, p, signed, special):
    lam = np.asarray(lam, np.float32)
    maps = _maps(seed, n, p, signed, special)
    got = search_table(*maps, lam)
    np.testing.assert_array_equal(got, plain(maps, lam))
    np.testing.assert_array_equal(got, pallas(maps, lam))
