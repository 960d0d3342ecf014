"""The graph generators and the traffic generator: deterministic per
seed, and true to their parameters."""

import torch

from portbench import generator
from portbench.graphs import band, kronecker

KRON = {"scale": 12, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05,
        "graph_seed": 4}


def test_kronecker_is_deterministic_per_seed():
    a = kronecker.make(KRON, 2**31 + 5, "cpu")
    b = kronecker.make(KRON, 2**31 + 5, "cpu")
    c = kronecker.make(KRON, 2**31 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    # the graph is the configuration's: the run's seed does not change it
    assert all(torch.equal(x, y) for x, y in zip(a[:3], c[:3]))
    d = kronecker.make(dict(KRON, graph_seed=5), 2**31 + 5, "cpu")
    assert not torch.equal(a[0], d[0]) and not torch.equal(a[2], d[2])


def test_kronecker_quadrant_shares():
    g = torch.Generator()
    g.manual_seed(3)
    i, j = kronecker.edges(12, 16, 0.57, 0.19, 0.19, g, "cpu")
    m = i.numel()
    assert m == 16 << 12
    for bit in (0, 11):
        ib, jb = (i >> bit) & 1, (j >> bit) & 1
        shares = [float(((ib == r) & (jb == c)).sum()) / m for r, c in ((0, 0), (0, 1), (1, 0), (1, 1))]
        for got, want in zip(shares, (0.57, 0.19, 0.19, 0.05)):
            assert abs(got - want) < 0.005, (bit, shares)


def test_kronecker_symmetric_without_self_loops():
    rows, cols, vals, n = kronecker.make(KRON, 9, "cpu")
    assert n == 1 << 12
    assert not bool((rows == cols).any())
    assert int(rows.max()) < n and int(cols.max()) < n
    half = rows.numel() // 2
    assert torch.equal(rows[:half], cols[half:]) and torch.equal(cols[:half], rows[half:])
    assert torch.equal(vals[:half], vals[half:])
    assert float(vals.min()) >= 0.0 and float(vals.max()) < 1.0
    # duplicates stay in the list
    assert torch.unique(rows * n + cols).numel() < rows.numel()


def test_band_entries_and_order():
    rows, cols, vals, n = band.make({"n": 1 << 19, "bandwidth": 63, "values": [0.1, 1.0]}, 1, "cpu")
    assert n == 1 << 19 and rows.numel() == 66_580_544
    assert int((rows - cols).abs().max()) == 63
    key = rows * n + cols
    assert bool((key[1:] > key[:-1]).all())  # row-major, no duplicate
    assert float(vals.min()) >= 0.1 and float(vals.max()) <= 1.0


def test_band_is_deterministic_per_seed():
    p = {"n": 4096, "bandwidth": 7, "values": [0.1, 1.0]}
    a, b, c = (band.make(p, s, "cpu")[2] for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_roots_follow_their_rule():
    rows = torch.tensor([0, 1, 5, 5])
    cols = torch.tensor([1, 0, 6, 6])
    t = {"roots": "nonisolated", "roots_drawn": 200}
    roots = generator.roots(t, 2**32 + 1, 10, rows, cols, "cpu")
    assert set(roots) == {0, 1, 5, 6}
    assert roots == generator.roots(t, 2**32 + 1, 10, rows, cols, "cpu")
    head = generator.roots({"roots": "head", "head": 4, "roots_drawn": 500}, 3, 10, rows, cols, "cpu")
    assert set(head) == {0, 1, 2, 3}


def test_spmv_vectors_ring():
    t = {"ring": 8, "x_range": [-1.0, 1.0]}
    xs = generator.spmv_vectors(t, 7, 100, "cpu")
    assert len(xs) == 8 and all(x.shape == (100,) and x.dtype == torch.float32 for x in xs)
    assert float(torch.stack(xs).min()) >= -1.0 and float(torch.stack(xs).max()) < 1.0
    assert all(torch.equal(x, y) for x, y in zip(xs, generator.spmv_vectors(t, 7, 100, "cpu")))
