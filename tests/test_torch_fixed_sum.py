"""The fixed-order sums of the port's CUDA walks (csrc/fixed_sum.cuh), on
the CPU.

No CUDA kernel runs here: a Python twin of the slot layouts (``SymPass``,
``sym_plan``, ``row_plan``) walks the blocks of each layout as the kernels
do and checks that every slot the sums read is written exactly once, by
one block, that no two partials share a slot, and that the slots summed in
order give the product.  The constants are read from the source, and the
workspaces of the shapes ``chip_smoke.py`` runs stay within 1 GiB.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "plssvm_tpu_torch", "csrc")
GIB = 1 << 30


def _source(name):
    return open(os.path.join(CSRC, name), encoding="utf-8").read()


def _budget():
    found = re.search(r"kWorkspaceBudget = int64_t\((\d+)\) << (\d+);", _source("fixed_sum.cuh"))
    return int(found.group(1)) << int(found.group(2))


class SymPass:
    """fixed_sum.cuh's SymPass."""

    def __init__(self, j0, j1, edge, C):
        self.j0, self.j1, self.edge, self.C = j0, j1, edge, C

    def split(self):
        return self.j0 * self.edge

    def width(self):
        return (self.j1 - self.j0) * self.edge

    def slab_values(self):
        return (self.j1 - self.j0) * self.split() * self.C

    def values(self):
        return self.slab_values() + self.j1 * self.width() * self.C

    def first_block(self):
        return self.j0 * (self.j0 + 1) // 2

    def blocks(self):
        return self.j1 * (self.j1 + 1) // 2 - self.first_block()

    def slot(self, r, p):
        if r < self.split():
            return ((p - self.j0) * self.split() + r) * self.C
        return self.slab_values() + (p * self.width() + r - self.split()) * self.C


def sym_plan(m, edge, step, C, item, budget):
    """fixed_sum.cuh's sym_plan with the budget a parameter."""
    nt = -(-m // edge)
    limit = budget // item
    passes, j0 = [], 0
    while j0 < nt:
        j1 = min(nt, j0 + step)
        while j1 < nt:
            nxt = min(nt, j1 + step)
            if SymPass(j0, nxt, edge, C).values() > limit:
                break
            j1 = nxt
        passes.append(SymPass(j0, j1, edge, C))
        j0 = j1
    return passes


def row_plan(n, edge, item, values, budget):
    """fixed_sum.cuh's row_plan: (tiles a band, the largest band's bytes)."""
    nt = -(-n // edge)
    limit = budget // item
    lo, hi = 1, nt
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if values(min(n, mid * edge)) <= limit:
            lo = mid
        else:
            hi = mid - 1
    bands = -(-n // (lo * edge))
    most = max(values(min(n - b * lo * edge, lo * edge)) * item for b in range(bands))
    return lo, most


def upper_triangle_tile(p):
    jt = int(((8 * p + 1) ** 0.5 - 1) / 2)
    while jt * (jt + 1) // 2 > p:
        jt -= 1
    while (jt + 1) * (jt + 2) // 2 <= p:
        jt += 1
    return p - jt * (jt + 1) // 2, jt


def grouped_upper_tile(p, nt, group=16):
    """gram_tc.cuh's grouped raster."""
    def before(g):
        return group * group * g * (g - 1) // 2 + g * group * (group + 1) // 2

    g = 0
    while before(g + 1) <= p:
        g += 1
    j0 = g * group
    w = min(nt - j0, group)
    q = p - before(g)
    if q < j0 * w:
        return q // w, j0 + q % w
    q -= j0 * w
    r = 0
    while q >= w - r:
        q -= w - r
        r += 1
    return j0 + r, j0 + r + q


def _sym_product(m, edge, step, C, budget, raster, rng):
    """The symmetric walk as the kernels write it, K @ V summed through the
    slots pass by pass; asserts the slot invariants on the way."""
    X = rng.standard_normal((m, 3))
    K = np.exp(-((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    V = rng.standard_normal((m, C))
    nt = -(-m // edge)
    out = np.zeros((m, C))
    passes = sym_plan(m, edge, step, C, 8, budget)
    assert passes[0].j0 == 0 and passes[-1].j1 == nt
    assert all(a.j1 == b.j0 for a, b in zip(passes, passes[1:]))
    for p in passes:
        ws = np.full(p.values(), np.nan)
        writes = np.zeros(p.values(), dtype=int)
        for b in range(p.blocks()):
            it, jt = raster(p.first_block() + b, nt)
            assert p.j0 <= jt < p.j1 and it <= jt
            rows = range(it * edge, min((it + 1) * edge, m))
            cols = range(jt * edge, min((jt + 1) * edge, m))
            for r in rows:  # the row sums against column tile jt
                at = p.slot(r, jt)
                ws[at:at + C] = sum(K[r, j] * V[j] for j in cols)
                writes[at:at + C] += 1
            if jt > it:  # the column sums against row tile it
                for j in cols:
                    at = p.slot(j, it)
                    ws[at:at + C] = sum(K[r, j] * V[r] for r in rows)
                    writes[at:at + C] += 1
        assert writes.max() <= 1
        # the sums read the slab's partners j0 .. j1 - 1 and the square's
        # 0 .. j1 - 1: every slot they read was written once
        for r in range(min(p.split(), m)):
            for q in range(p.j0, p.j1):
                assert writes[p.slot(r, q)] == 1
                out[r] += ws[p.slot(r, q):p.slot(r, q) + C]
        for r in range(p.split(), min(p.split() + p.width(), m)):
            for q in range(p.j1):
                assert writes[p.slot(r, q)] == 1
                out[r] += ws[p.slot(r, q):p.slot(r, q) + C]
    np.testing.assert_allclose(out, K @ V, rtol=1e-12, atol=1e-12)
    return passes


@pytest.mark.parametrize("m, edge, step, C, budget", [
    (7, 2, 1, 1, 1 << 20),      # one pass
    (23, 4, 1, 2, 8 * 120),     # several passes of one tile's step
    (50, 3, 2, 3, 8 * 900),     # steps of two tiles, a ragged last tile
    (97, 8, 4, 1, 8 * 1200),
])
def test_the_symmetric_passes_write_each_slot_once(m, edge, step, C, budget):
    rng = np.random.default_rng(m)
    passes = _sym_product(m, edge, step, C, budget, lambda p, nt: upper_triangle_tile(p), rng)
    if budget < 1 << 20:
        assert len(passes) > 1
        assert all(p.values() * 8 <= budget or p.j1 - p.j0 == step for p in passes)


def test_the_grouped_raster_passes_write_each_slot_once():
    """The tensor-core and DMMA tiles' raster, in passes of whole groups of
    16 column tiles: each pass is a contiguous run of its blocks."""
    rng = np.random.default_rng(3)
    passes = _sym_product(37 * 2, 2, 16, 1, 8 * 2500, grouped_upper_tile, rng)
    assert len(passes) == 2 and passes[0].j1 == 32


def test_the_budget_is_at_most_a_gib():
    assert 0 < _budget() <= GIB


@pytest.mark.parametrize("name, m, edge, step, C, item", [
    ("C MNIST width, f32", 60000, 128, 16, 10, 4),
    ("C MNIST width, f64 DMMA", 60000, 128, 16, 10, 8),
    ("G chi2 width, f32", 60000, 64, 1, 10, 4),
    ("G chi2 width, f64", 60000, 64, 1, 10, 8),
    ("A config 2", 10000, 128, 16, 1, 4),
])
def test_the_symmetric_workspaces_at_chip_smoke_shapes(name, m, edge, step, C, item):
    """Every pass of the symmetric walks at the shapes chip_smoke.py runs
    fits 1 GiB; MNIST's and chi2-width's C = 10 products take more than
    one pass, config 2's A one."""
    passes = sym_plan(m, edge, step, C, item, _budget())
    assert max(p.values() * item for p in passes) <= GIB
    assert (len(passes) == 1) == (C == 1)
    nt = -(-m // edge)
    assert sum(p.blocks() for p in passes) == nt * (nt + 1) // 2


@pytest.mark.parametrize("n, n_cols, edge, C, item", [
    (10000, 60000, 128, 10, 8),    # float64 predict against 60000 SVs
    (60000, 60000, 128, 10, 8),
    (15000, 15000, 128, 10, 8),    # the ring's dual block
    (30000, 30000, 64, 1, 8),      # a chi-squared walk
])
def test_the_row_bands_fit_the_budget(n, n_cols, edge, C, item):
    """run_rows' bands: each band's row slots (one per column tile) and
    column slots (one per band row tile) fit the budget."""
    n_ct = -(-n_cols // edge)

    def values(rows):
        tiles = -(-rows // edge)
        return n_ct * tiles * edge * C + tiles * n_cols * C

    tiles, most = row_plan(n, edge, item, values, _budget())
    assert most <= GIB and tiles >= 1
    if values(n) * item <= _budget():
        assert tiles * edge >= n


def _walk_block(u, n_units, grid):
    return ((u + 1) * grid - 1) // n_units


@pytest.mark.parametrize("n_tiles, n_strips, grid", [
    (5, 7, 3), (3, 40, 16), (12, 2, 7), (4, 4, 16), (1, 9, 9), (30, 3, 8)])
def test_the_walk_row_slots_cover_each_tile_once(n_tiles, n_strips, grid):
    """The matvec walk of dual.cu: block b runs units [U b / G, U (b + 1) /
    G); a block that reaches a row tile writes slot b - walk_block(first
    unit of the tile), below walk_row_slots, and no two blocks of a tile
    share a slot."""
    n_units = n_tiles * n_strips
    grid = min(grid, n_units)
    most = 0
    for t in range(n_tiles):
        first = _walk_block(t * n_strips, n_units, grid)
        last = _walk_block((t + 1) * n_strips - 1, n_units, grid)
        most = max(most, last - first + 1)
    seen = set()
    for b in range(grid):
        units = range(n_units * b // grid, n_units * (b + 1) // grid)
        for t in sorted({u // n_strips for u in units}):
            assert _walk_block(t * n_strips, n_units, grid) <= b
            slot = b - _walk_block(t * n_strips, n_units, grid)
            assert 0 <= slot < most and (t, slot) not in seen
            seen.add((t, slot))
    assert {t for t, _ in seen} == set(range(n_tiles))


def test_no_kernel_adds_with_atomics():
    """Every csrc source sums across blocks through the slots: no call of
    atomicAdd is left, only words in comments."""
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            code = re.sub(r"//[^\n]*", "", _source(name))
            assert "atomicAdd(" not in code, name


def test_the_reduction_on_cpu_tensors_sums_the_slots_in_order():
    """``gram_matvec.fixed_sum`` on CPU tensors takes its plain version,
    which adds the slots one after another from slot 0 and then adds the
    total to ``out``: the kernel's order, so its bits; nothing is launched."""
    import torch

    from plssvm_tpu_torch.ops import gram_matvec, matvec

    g = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        slots = torch.randn(37, 3, 11, generator=g, dtype=dtype) * 10.0 ** torch.arange(
            37, dtype=dtype).remainder(9).reshape(37, 1, 1)
        out = torch.randn(3, 11, generator=g, dtype=dtype)
        total = torch.zeros_like(out)
        for part in slots:
            total = total + part
        got = gram_matvec.fixed_sum(slots, out.clone())
        assert torch.equal(got, out + total)
        assert torch.equal(got, matvec.fixed_sum_plain(slots, out))
        # another order rounds otherwise on these magnitudes
        assert not torch.equal(got, out + slots.flip(0).sum(0))
    assert gram_matvec.fixed_sum_launches() == 0
