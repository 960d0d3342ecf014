"""The Graph500 Kronecker generator (Graph500 specification 3.0, section 3).

Each of edgefactor · 2^scale edges picks one quadrant of the adjacency
matrix per bit of its endpoints, with probabilities A, B, C and D. The
vertex labels are then permuted at random, self-loops dropped, and each
edge stored in both directions (the graph is undirected). Duplicate edges
stay; the program folds them by the semiring's ⊕. Weights are U[0, 1) in
float32, one per edge, the same in both directions.

The whole graph is drawn from the configuration's ``graph_seed``, not from
the run's seed: each draw of the edges or the weights is another graph,
with its own largest rows and its own hop counts, and so another amount
of work (a solve's mean step count moved by 5% between weight draws on
one structure). The run's seed draws the traffic on it.
"""

from __future__ import annotations

import torch


def edges(scale: int, edgefactor: int, a: float, b: float, c: float,
          g: torch.Generator, device):
    """(i, j): the specification's edge list before its labels are
    permuted, int64 on ``device``."""
    m = edgefactor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=g, device=device) > ab
        j_bit = torch.rand(m, generator=g, device=device) > torch.where(
            i_bit, c_norm, a_norm)
        i |= i_bit.to(torch.int64) << bit
        j |= j_bit.to(torch.int64) << bit
        del i_bit, j_bit
    return i, j


def make(params: dict, seed: int, device):
    """The graph of ``params["graph_seed"]``; ``seed`` is not used."""
    scale = int(params["scale"])
    n = 1 << scale
    g = torch.Generator(device=device)
    g.manual_seed(int(params["graph_seed"]))
    i, j = edges(scale, int(params["edgefactor"]), float(params["a"]), float(params["b"]),
                 float(params["c"]), g, device)
    perm = torch.randperm(n, generator=g, device=device)
    i, j = perm[i], perm[j]
    keep = i != j
    i, j = i[keep], j[keep]
    w = torch.rand(i.numel(), generator=g, device=device)
    return torch.cat([i, j]), torch.cat([j, i]), torch.cat([w, w]), n
