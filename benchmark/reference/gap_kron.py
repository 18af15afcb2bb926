"""GAP's ``kron`` graph as PageRank's transition operator, on the device.

Frozen copy of ``kron_graph`` and ``transition`` in
``sparsematrixvectormultiplication_tpu_torch/models/kron_pagerank_reference.py``
as first written: the Graph500 Kronecker generator the GAP Benchmark Suite
runs for ``kron`` (https://github.com/sbeamer/gapbs, ``generator.h``;
Beamer, Asanovic, Patterson, arXiv:1508.03619): ``edge_factor * 2**scale``
edges, each drawn over ``scale`` levels of the initiator A/B/C/D =
0.57/0.19/0.19/0.05, vertex labels randomly permuted, then symmetrized with
self-loops and duplicate edges dropped. The random stream is a
``torch.Generator`` on the device seeded with the run's seed, not GAP's
``std::mt19937``: the same law, other draws.

The matrix returned is P = A D^-1 itself: each stored edge (i, j) holds
1/deg(j) in float64, so ``P @ p`` is one PageRank step's product; A is
symmetric, so no transpose. The vertices with no edge are P's empty
columns (the dangling mask) and its empty rows.
"""

from __future__ import annotations

import torch

from .matrix import Matrix

INITIATOR = (0.57, 0.19, 0.19)  # A, B, C; D = 1 - A - B - C


def kron_graph(scale: int, edge_factor: int, seed: int, device) -> tuple:
    """``(n, row, col)``: the symmetric adjacency's int64 coordinates in
    row-major order, each edge {u, v} stored as (u, v) and (v, u)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    n = 1 << scale
    m = edge_factor * n
    a, b, c = INITIATOR
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=g, device=device) > ab
        jj = torch.rand(m, generator=g, device=device) > torch.where(
            ii, c_norm, a_norm)
        u |= ii.to(torch.int64) << level
        v |= jj.to(torch.int64) << level
    perm = torch.randperm(n, generator=g, device=device)
    u, v = perm[u], perm[v]
    keep = u != v
    u, v = u[keep], v[keep]
    key = torch.unique(torch.cat([u * n + v, v * n + u]))
    return n, key // n, key % n


def generate(params: dict, seed: int, device) -> Matrix:
    """P of the graph of ``params`` (``scale``, ``edge_factor``) drawn from
    ``seed``, on ``device``."""
    n, row, col = kron_graph(int(params["scale"]),
                             int(params["edge_factor"]), seed, device)
    deg = torch.bincount(col, minlength=n)
    return Matrix(n, n, row, col, 1.0 / deg[col].to(torch.float64))
