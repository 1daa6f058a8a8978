"""The row-tiled bf16 K1f and K1b kernels' plan and addressing, on the CPU.

``ops/upsample.upsample_plan`` cuts a plane into tiles of rows walked by
threads of ``vec`` columns (``csrc/upsample2x_tile.cuh`` computes the same
plan). The kernels cannot run here, so their addressing is emulated in
numpy, thread by thread as the CUDA code walks it: K1f's register window
of rows i - 1, i, i + 1 (zero rows past the edges), the halo columns
clamped onto the row's edge, the H lerps rounded to bf16 after every
operation, the W taps as two exact f32 products added once and rounded;
K1b's W partials of each cotangent row kept for the next dx row, the
clamped rows and columns. Both are held bit for bit to the plain versions
(``upsample2x_plain``, ``upsample2x_bwd_plain``) in bf16, every output
written exactly once.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from im2im_uq_tpu_torch.ops import upsample
from _torch_port_ranks import one_intra_op_thread  # noqa: F401  (autouse)

CSRC = Path(upsample.__file__).resolve().parent.parent / "csrc"
# (h, w) of K1's planes: the decoder's, chip_smoke's odd shapes, H not
# divisible by the tile's rows (37, 17, 13, 3), a row wider than a block
# (300)
DECODER_HW = [s[2:] for s in chip_smoke.DECODER_SHAPES]
ODD_HW = [s[2:] for s in chip_smoke.ODD_SHAPES]
RAGGED_HW = [(37, 24), (17, 300), (13, 16), (3, 8)]
PLAN_HW = DECODER_HW + ODD_HW + RAGGED_HW


def _vecs(w: int, vector: int) -> list[int]:
    return [1, vector] if w % vector == 0 else [1]


def _tile_rows(p: upsample.UpsamplePlan, tile: int, h: int) -> range:
    """The rows a tile's threads own (the last tile ragged)."""
    return range(tile * p.rows, min((tile + 1) * p.rows, h))


@pytest.mark.parametrize("hw", PLAN_HW, ids=str)
def test_plan_tiles_cover_every_row_and_column_once(hw):
    h, w = hw
    for vec in sorted({1, *_vecs(w, upsample.FWD_VECTOR), *_vecs(w, upsample.BWD_VECTOR)}):
        p = upsample.upsample_plan(h, w, vec)
        tiles = [_tile_rows(p, t, h) for t in range(p.tiles)]
        assert [i for rows in tiles for i in rows] == list(range(h)), (hw, vec, p)
        assert all(len(rows) == p.rows for rows in tiles[:-1])
        cols = [j for ct in range(p.col_tiles) for u in range(p.units)
                for j in range((ct * p.units + u) * vec, (ct * p.units + u + 1) * vec) if j < w]
        assert cols == list(range(w)), (hw, vec, p)
        threads = p.units * p.groups
        assert upsample.BLOCK_THREADS <= threads <= upsample.MAX_THREADS, (hw, vec, p)


@pytest.mark.parametrize("hw", PLAN_HW, ids=str)
def test_vector_width_is_the_kernels_only_where_it_divides_w(hw):
    h, w = hw
    for vector in (upsample.FWD_VECTOR, upsample.BWD_VECTOR):
        assert upsample.vector_width(vector, w, 0, 256) == (vector if w % vector == 0 else 1)
        if w % vector:
            with pytest.raises(ValueError, match="does not fit"):
                upsample.upsample_plan(h, w, vector)


def test_decoder_shapes_take_the_vectors_with_whole_warps_and_whole_tiles():
    for h, w in DECODER_HW[1:]:
        for vector in (upsample.FWD_VECTOR, upsample.BWD_VECTOR):
            p = upsample.upsample_plan(h, w, upsample.vector_width(vector, w, 0, 0))
            assert p.vec == vector and p.col_tiles == 1 and h % p.rows == 0
            assert (p.units * p.groups) % 32 == 0
    # up1's 20x20 input, which the step takes through the XLA form: K1f's
    # vector fits, K1b's does not
    assert upsample.vector_width(upsample.FWD_VECTOR, 20, 0, 0) == upsample.FWD_VECTOR
    assert upsample.vector_width(upsample.BWD_VECTOR, 20, 0, 0) == 1


def test_an_unaligned_view_takes_vector_width_1():
    shape = (2, 3, 8, 16)
    n = int(np.prod(shape))
    x = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    y = torch.empty((2, 3, 16, 32), dtype=torch.bfloat16)
    aligned = torch.zeros(shape, dtype=torch.bfloat16)
    for vector in (upsample.FWD_VECTOR, upsample.BWD_VECTOR):
        assert upsample.vector_width(vector, 16, x.data_ptr(), y.data_ptr()) == 1
        assert upsample.vector_width(vector, 16, aligned.data_ptr(), y.data_ptr()) == vector
    # the same view through the wrapper's CPU path: the plain version
    assert torch.equal(upsample.upsample2x(x), upsample.upsample2x_plain(aligned))


def test_the_cuda_plan_has_the_python_constants():
    text = (CSRC / "upsample2x_tile.cuh").read_text()
    consts = dict(re.findall(r"\b(k\w+) = (\d+)", text))
    assert {k: int(v) for k, v in consts.items()} == {
        "kFwdVector": upsample.FWD_VECTOR, "kBwdVector": upsample.BWD_VECTOR,
        "kBlockThreads": upsample.BLOCK_THREADS, "kMaxThreads": upsample.MAX_THREADS,
        "kTileRows": upsample.TILE_ROWS, "kUnitsMax": upsample.UNITS_MAX}


# --- numpy emulation of the kernels ---------------------------------------


def _bf16(a) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest even), as f32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _threads(p: upsample.UpsamplePlan, w: int):
    """(tile, j0) of every thread that owns columns, for one plane group."""
    for tile in range(p.tiles):
        for ct in range(p.col_tiles):
            for u in range(p.units):
                j0 = (ct * p.units + u) * p.vec
                if j0 < w:
                    yield tile, j0


def emulate_fwd(x: np.ndarray, vec: int) -> tuple[np.ndarray, np.ndarray]:
    """upsample2x_tile_kernel<vec> on (planes, h, w) bf16 values held as f32
    → (y, how many times each output was written)."""
    planes, h, w = x.shape
    p = upsample.upsample_plan(h, w, vec)
    wh, ww = (t.numpy() for t in upsample._bf16_tables(h, w, torch.device("cpu")))
    y = np.zeros((planes, 2 * h, 2 * w), np.float32)
    writes = np.zeros(y.shape, np.int64)
    for tile, j0 in _threads(p, w):
        cols = j0 + np.arange(vec)
        halo = np.array([max(j0 - 1, 0), min(j0 + vec, w - 1)])
        taps = ww.reshape(4, w)[:, cols]

        def row(i):  # the Row: mid columns and the halo pair; zero past the edges
            if 0 <= i < h:
                return x[:, i, cols], x[:, i, halo]
            return np.zeros((planes, vec), np.float32), np.zeros((planes, 2), np.float32)

        rows = _tile_rows(p, tile, h)
        i0, i1 = rows.start, rows.stop
        m, c, nxt = row(i0 - 1), row(i0), row(i0 + 1)
        for i in range(i0, i1):
            fe, fo = np.float32(wh[i]), np.float32(wh[h + i])
            for phase, (a, b, f) in enumerate([(m, c, fe), (c, nxt, fo)]):
                lerp = [_bf16(a[k] + _bf16(_bf16(b[k] - a[k]) * f)) for k in range(2)]
                e = np.concatenate([lerp[1][:, :1], lerp[0], lerp[1][:, 1:]], 1)
                even = _bf16(np.float32(taps[0] * e[:, :-2]) + np.float32(taps[1] * e[:, 1:-1]))
                odd = _bf16(np.float32(taps[2] * e[:, 1:-1]) + np.float32(taps[3] * e[:, 2:]))
                out = 2 * i + phase
                y[:, out, 2 * cols], y[:, out, 2 * cols + 1] = even, odd
                writes[:, out, 2 * cols] += 1
                writes[:, out, 2 * cols + 1] += 1
            m, c, nxt = c, nxt, row(i + 2)
    return y, writes


def _taps(a, v):
    """((a1·v1 + a3·v3) + a2·v2) + a0·v0 in f32, each operation rounded."""
    f = np.float32
    s = f(f(a[1] * v[1]) + f(a[3] * v[3]))
    s = f(s + f(a[2] * v[2]))
    return f(s + f(a[0] * v[0]))


def emulate_bwd(g: np.ndarray, vec: int) -> tuple[np.ndarray, np.ndarray]:
    """upsample2x_bwd_tile_kernel<vec> on a (planes, 2h, 2w) bf16 cotangent
    held as f32 → (dx, writes)."""
    planes, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    p = upsample.upsample_plan(h, w, vec)
    ah = np.stack(upsample.transpose_weights(h))
    aw = np.stack(upsample.transpose_weights(w))
    dx = np.zeros((planes, h, w), np.float32)
    writes = np.zeros(dx.shape, np.int64)
    for tile, j0 in _threads(p, w):
        cols = j0 + np.arange(vec)
        mid = 2 * j0 + np.arange(2 * vec)
        left = 2 * j0 - 1 if j0 > 0 else 1
        right = 2 * (j0 + vec) if j0 + vec < w else 2 * (j0 + vec) - 2
        gcols = np.concatenate([[left], mid, [right]])
        a = aw[:, cols]
        reads = []

        def partials(q):  # the W partials of cotangent row q at the columns
            reads.append(q)
            v = g[:, q, gcols]
            return _taps(a, [v[:, 2 * np.arange(vec) + k] for k in range(4)])

        rows = _tile_rows(p, tile, h)
        i0, i1 = rows.start, rows.stop
        r0, r1 = partials(2 * i0 - 1 if i0 > 0 else 1), partials(2 * i0)
        for i in range(i0, i1):
            r2 = partials(2 * i + 1)
            r3 = partials(2 * i + 2) if i < h - 1 else r1
            dx[:, i, cols] = _bf16(_taps(ah[:, i], [r0, r1, r2, r3]))
            writes[:, i, cols] += 1
            r0, r1 = r2, r3
        # the tile's cotangent rows and the two above it, each once (row 1
        # twice in the first tile: it stands in for row -1)
        assert len(reads) == 2 * (i1 - i0) + 2 - (i1 == h)
        assert len(reads) - len(set(reads)) == (i0 == 0), reads
    return dx, writes


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


EMULATED_HW = DECODER_HW[1:2] + ODD_HW + RAGGED_HW + [(40, 16), (6, 20)]


@pytest.mark.parametrize("h,w,vec", [(h, w, vec) for h, w in EMULATED_HW
                                     for vec in _vecs(w, upsample.FWD_VECTOR)], ids=str)
def test_k1f_tiles_emulated_equal_the_plain_version_bit_for_bit(h, w, vec):
    rng = np.random.default_rng(h * 1000 + w)
    x = torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32)).to(torch.bfloat16)
    y, writes = emulate_fwd(x.float().numpy(), vec)
    assert (writes == 1).all()
    want = upsample.upsample2x_plain(x[None])[0]
    got = torch.from_numpy(y).to(torch.bfloat16)  # exact: y holds bf16 values
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("h,w,vec", [(h, w, vec) for h, w in EMULATED_HW
                                     for vec in _vecs(w, upsample.BWD_VECTOR)], ids=str)
def test_k1b_tiles_emulated_equal_the_plain_version_bit_for_bit(h, w, vec):
    rng = np.random.default_rng(h * 1000 + w + 1)
    g = torch.from_numpy(rng.standard_normal((3, 2 * h, 2 * w)).astype(np.float32))
    g = g.to(torch.bfloat16)
    dx, writes = emulate_bwd(g.float().numpy(), vec)
    assert (writes == 1).all()
    want = upsample.upsample2x_bwd_plain(g[None])[0]
    got = torch.from_numpy(dx).to(torch.bfloat16)
    assert np.array_equal(_bits(got), _bits(want))


def test_sass_counts_reads_the_k1_kernels_instructions_and_calls():
    from im2im_uq_tpu_torch.scripts.compare_upsample_builds import sass_counts

    text = """
\tFunction : _ZN12_GLOBAL__N_122upsample2x_tile_kernelILi8EEEvPK13__nv_bfloat16PS1_PKfS6_xiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 CALL.REL.NOINC 0x120 ;     /* 0x000000f000008944 */
        /*0020*/                   EXIT ;                     /* 0x000000000000794d */
        /*0030*/                   NOP;
\tFunction : _ZN12_GLOBAL__N_111other_kernelEv
        /*0000*/                   CALL.REL.NOINC 0x40 ;
"""
    name = "_ZN12_GLOBAL__N_122upsample2x_tile_kernelILi8EEEvPK13__nv_bfloat16PS1_PKfS6_xiiii"
    assert sass_counts(text) == {name: {"instructions": 3, "calls": 1}}
