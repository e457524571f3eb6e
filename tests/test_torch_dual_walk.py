"""The index math of the matvec walk of kernels J and L on the CPU.

``matvec_dual_kernel`` (plssvm_tpu_torch/csrc/dual.cu) splits an mr x mc
block into units, one strip of 2 RB columns of one row tile of 16 RA rows,
and gives block b of a persistent grid of G blocks the units [b U / G, (b
+ 1) U / G).  A block walks its run in steps of up to 8 strips of one row
tile, two warps a strip (each half the rows) in a step of 4 strips or
fewer; a thread holds its rows and columns in runs of 16 bytes.  This file
holds a Python twin of that partition (``walk_step``, ``walk_next``,
``walk_row``, ``walk_col``, ``walk_count``) and checks that every unit and
pair of the block is computed exactly once, by one thread, for ragged
blocks and the ring's, at the grids the card gives; a test holds the
constants it models to the source's.  The kernel itself runs against its
plain version in tests/test_torch_cuda.py on the card.
"""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUAL = os.path.join(REPO, "plssvm_tpu_torch", "csrc", "dual.cu")
TILE = os.path.join(REPO, "plssvm_tpu_torch", "csrc", "gram_tile.cuh")


#: the walk's warps a block (kWalkWarps), column lanes a warp
#: (kStripLanes), row lanes a warp (gram_tile.cuh kThreads) and features a
#: staged chunk (kChunk)
WARPS, STRIP_LANES, LANES, CHUNK = 8, 2, 16, 16
THREADS = 32 * WARPS

#: (bytes of a value, RA, RB) of WalkTile's instantiations: the float 8 x 8
#: (Gram, laplacian), the float and double 4 x 4 (chi-squared, double
#: laplacian)
TILES = [(4, 8, 8), (4, 4, 4), (8, 4, 4)]


def _constant(path, name):
    text = open(path, encoding="utf-8").read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_twins_constants_are_the_sources():
    assert (_constant(DUAL, "kWalkWarps"), _constant(DUAL, "kStripLanes"),
            _constant(TILE, "kThreads"), _constant(TILE, "kChunk")) == (
        WARPS, STRIP_LANES, LANES, CHUNK)
    text = open(DUAL, encoding="utf-8").read()
    assert "static constexpr int kRows = kWide ? 8 : 4;" in text
    assert "static constexpr int kCols = kWide ? 8 : 4;" in text


def walk_step(unit, end, n_strips, bm, sw):
    """(row0, col0, strips) of the step starting at ``unit``; strips 0 past
    ``end``."""
    if unit >= end:
        return 0, 0, 0
    tile, strip0 = divmod(unit, n_strips)
    n = min(n_strips - strip0, end - unit, WARPS)
    return tile * bm, strip0 * sw, n


def block_steps(b, grid, n_units, n_strips, bm, sw):
    """The steps of block b's run, as walk_step / walk_next make them."""
    end = n_units * (b + 1) // grid
    step = walk_step(n_units * b // grid, end, n_strips, bm, sw)
    steps = []
    while step[2]:
        steps.append(step)
        row0, col0, strips = step
        unit = row0 // bm * n_strips + col0 // sw + strips
        step = walk_step(unit, end, n_strips, bm, sw)
    return steps


def walk_row(a, lr, vec):
    return a // vec * (LANES * vec) + lr * vec + a % vec


def walk_col(b, lc, vec):
    return b // vec * (STRIP_LANES * vec) + lc * vec + b % vec


def walk_count(r0, n, cap):
    """The number of i >= 0 with r0 + 16 i < n, at most cap."""
    return min(-(-(n - r0) // (THREADS // CHUNK)), cap) if n > r0 else 0


SHAPES = [(1, 1), (128, 128), (64, 64), (129, 128), (128, 129), (65, 64), (300, 200),
          (2500, 2100), (300, 2500), (2500, 2500)]
#: the card's 132 SMs at 1 and 2 blocks an SM, and a few grids that do not
#: divide the units
GRIDS = [1, 7, 132, 264]


@pytest.mark.parametrize("itemsize,ra,rb", TILES)
@pytest.mark.parametrize("mr,mc", SHAPES)
@pytest.mark.parametrize("slots", GRIDS)
def test_every_unit_once_in_runs_one_unit_apart(itemsize, ra, rb, mr, mc, slots):
    bm, sw = LANES * ra, STRIP_LANES * rb
    n_strips = -(-mc // sw)
    n_units = -(-mr // bm) * n_strips
    grid = min(n_units, slots)
    seen = {}
    runs = []
    for b in range(grid):
        steps = block_steps(b, grid, n_units, n_strips, bm, sw)
        runs.append(sum(s[2] for s in steps))
        assert steps, "a block without a step"
        for row0, col0, strips in steps:
            assert 1 <= strips <= WARPS
            assert col0 % sw == 0 and col0 // sw + strips <= n_strips  # one row tile
            for k in range(strips):
                unit = (row0 // bm, col0 // sw + k)
                assert unit not in seen
                seen[unit] = b
    assert len(seen) == n_units
    assert max(runs) - min(runs) <= 1


@pytest.mark.parametrize("itemsize,ra,rb", TILES)
@pytest.mark.parametrize("strips", range(1, WARPS + 1))
def test_a_step_covers_its_pairs_once(itemsize, ra, rb, strips):
    """The warps of a step of ``strips`` strips (two a strip, each half
    the rows, at 4 strips or fewer) and their lanes hold every pair of the
    row tile and the step's columns exactly once."""
    vec = 16 // itemsize
    bm, sw = LANES * ra, STRIP_LANES * rb
    share = 2 if 2 * strips <= WARPS else 1
    held = {}
    for warp in range(WARPS):
        half = warp % share
        if warp // share >= strips:
            continue
        col = warp // share * sw
        for lane in range(32):
            lr, lc = lane % LANES, lane // LANES
            for a in range(ra):
                if share == 2 and a // (ra // 2) != half:
                    continue
                for b in range(rb):
                    pair = (walk_row(a, lr, vec), col + walk_col(b, lc, vec))
                    assert pair not in held
                    held[pair] = (warp, lane)
    assert set(held) == {(r, c) for r in range(bm) for c in range(strips * sw)}
    assert sum(1 for w in range(WARPS) if w // share < strips) == strips * share


@pytest.mark.parametrize("itemsize,ra,rb", TILES)
def test_a_threads_rows_and_columns_are_aligned_runs(itemsize, ra, rb):
    """A thread's rows (and columns) come in runs of 16 bytes that start on
    16-byte boundaries of a stage row (padded by 16 bytes), so each run is
    one 16-byte load; the 16 row lanes' runs of one load are side by side."""
    vec = 16 // itemsize
    for lr in range(LANES):
        for a0 in range(0, ra, vec):
            rows = [walk_row(a, lr, vec) for a in range(a0, a0 + vec)]
            assert rows == list(range(rows[0], rows[0] + vec)) and rows[0] % vec == 0
    for lc in range(STRIP_LANES):
        for b0 in range(0, rb, vec):
            cols = [walk_col(b, lc, vec) for b in range(b0, b0 + vec)]
            assert cols == list(range(cols[0], cols[0] + vec)) and cols[0] % vec == 0
    first = sorted(walk_row(0, lr, vec) for lr in range(LANES))
    assert first == list(range(0, LANES * vec, vec))


@pytest.mark.parametrize("itemsize,ra,rb", TILES)
@pytest.mark.parametrize("rows_left,cols_left", [(1000, 1000), (1, 1), (17, 3), (0, 5)])
@pytest.mark.parametrize("strips", [1, 3, 4, 8])
def test_the_copies_stage_each_value_once(itemsize, ra, rb, rows_left, cols_left, strips):
    """Thread t copies feature t % 16 of rows t / 16 + 16 i: each (row,
    feature) of the row tile and of the step's columns lands once, zero-
    filled past mr / mc (``rows_left``, ``cols_left`` of them left)."""
    bm, sw = LANES * ra, STRIP_LANES * rb
    y_max = WARPS * sw // (THREADS // CHUNK)
    x, y = {}, {}
    for t in range(THREADS):
        r0, kk0 = t // CHUNK, t % CHUNK
        x_ok = walk_count(r0, rows_left, ra)
        y_rows = walk_count(r0, strips * sw, y_max)
        y_ok = walk_count(r0, cols_left, y_rows)
        for i in range(ra):
            key = (r0 + (THREADS // CHUNK) * i, kk0)
            assert key not in x
            x[key] = i < x_ok
        for i in range(y_rows):
            key = (r0 + (THREADS // CHUNK) * i, kk0)
            assert key not in y
            y[key] = i < y_ok
    assert set(x) == {(r, k) for r in range(bm) for k in range(CHUNK)}
    assert set(y) == {(c, k) for c in range(strips * sw) for k in range(CHUNK)}
    assert all(ok == (r < rows_left) for (r, _), ok in x.items())
    assert all(ok == (c < cols_left) for (c, _), ok in y.items())
