"""Plain PageRank on the GAP benchmark suite's ``kron`` graph, in PyTorch.

The yardstick the port's PageRank is held to: a straightforward version of
the same semantics that imports neither JAX nor any module of this package,
and runs on any device, in float32 or float64.

* :func:`kron_graph`: the Graph500 Kronecker generator as the GAP Benchmark
  Suite runs it for ``kron`` (Beamer, Asanovic, Patterson,
  arXiv:1508.03619; https://github.com/sbeamer/gapbs, ``generator.h``):
  ``edge_factor * 2**scale`` edges, each drawn over ``scale`` levels of the
  initiator A/B/C/D = 0.57/0.19/0.19/0.05, vertex labels randomly
  permuted; then, as GAP builds it, symmetrized with self-loops and
  duplicate edges dropped.
* :func:`transition`: the operator P = A D^-1 of the random surfer, entry
  (i, j) = 1/deg(j) for each edge; A is symmetric, so no transpose.
* :func:`pagerank`: power iteration on the Google matrix with damping
  ``alpha`` from the uniform vector, the product by ``index_add_``; it
  stops when an iteration moves p by at most ``tol`` in L1, or after
  ``maxiter`` iterations (GAP's ``pr_spmv.cc``: 0.85, 1e-4, 20).

Departures from GAP:

* dangling mass: GAP's ``pr_spmv.cc`` drops the rank of vertices with no
  edges (its scores then sum to less than 1); here, as in the port's
  ``solvers.power.pagerank``, it is spread uniformly, so p sums to 1;
* the random stream: GAP draws from its own ``std::mt19937``; here from a
  ``torch.Generator`` seeded with ``seed`` on ``device`` (the same seed
  gives another graph on the CPU than on a card, of the same law);
* the update: GAP's ``pr_spmv.cc`` scores ``base + alpha * sum`` over
  incoming contributions ``p(j)/deg(j)``; that is P p here, the values
  1/deg(j) stored on the entries.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["kron_graph", "transition", "pagerank", "spmv"]

INITIATOR = (0.57, 0.19, 0.19)  # A, B, C; D = 1 - A - B - C


def kron_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               device="cpu") -> tuple:
    """The symmetric adjacency of a Kronecker graph: ``(n, row, col)``,
    int64 coordinates of every stored entry in row-major order, each edge
    {u, v} stored as (u, v) and (v, u), no self-loop, no duplicate."""
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


def transition(n: int, row: torch.Tensor, col: torch.Tensor,
               dtype=torch.float64) -> tuple:
    """``(val, dangling)``: P's value 1/deg(col) on every entry, and the
    mask of the vertices with no edge (P's empty columns)."""
    deg = torch.bincount(col, minlength=n)
    val = 1.0 / deg[col].to(dtype)
    return val, deg == 0


def spmv(n: int, row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
         p: torch.Tensor) -> torch.Tensor:
    """``P @ p`` in ``p``'s dtype: each entry's product added into its row
    by ``index_add_``."""
    y = torch.zeros(n, dtype=p.dtype, device=p.device)
    return y.index_add_(0, row, val.to(p.dtype) * p[col])


def pagerank(n: int, row: torch.Tensor, col: torch.Tensor,
             val: torch.Tensor, dangling: torch.Tensor, *,
             alpha: float = 0.85, tol: float = 1e-4, maxiter: int = 20,
             dtype=torch.float64) -> tuple:
    """``(p, iters, delta)`` of power iteration from the uniform vector:
    ``p <- alpha * (P p + (d . p) / n) + (1 - alpha) / n``, the dangling
    mass ``d . p`` spread uniformly, until the L1 move ``delta`` of an
    iteration is at most ``tol`` or ``maxiter`` iterations have run
    (``tol=-1`` runs exactly ``maxiter``)."""
    p = torch.full((n,), 1.0 / n, dtype=dtype, device=row.device)
    d = dangling.to(dtype)
    delta = float("inf")
    k = 0
    while k < maxiter and delta > tol:
        leaked = torch.dot(d, p)
        q = alpha * (spmv(n, row, col, val, p) + leaked / n) \
            + (1.0 - alpha) / n
        delta = float(torch.sum(torch.abs(q - p)))
        p = q
        k += 1
    return p, k, delta
