"""The fp64 PageRank that decides the PageRank cells' ``correct``.

Frozen copy, in float64, of ``pagerank`` in
``sparsematrixvectormultiplication_tpu_torch/models/kron_pagerank_reference.py``
as first written, for a given number of iterations: from the uniform
vector, ``p <- alpha * (P p + (d . p) / n) + (1 - alpha) / n``, d the mask
of P's empty columns (the dangling vertices, whose mass is spread
uniformly), the product by ``index_add_`` over the generated coordinates,
on the device the matrix is on. Nothing the package under test made is
read.
"""

from __future__ import annotations

import math

import torch

from .matrix import Matrix


def iterate(m: Matrix, iters: int, alpha: float) -> tuple:
    """``(p, move)``: p after exactly ``iters`` iterations, float64, and
    the L1 move of the last of them, ``||p_iters - p_(iters-1)||_1`` (inf
    for none): GAP's stop rule holds at ``iters`` where it is at most the
    tolerance."""
    n = m.nrows
    dangling = (torch.bincount(m.col, minlength=n) == 0).to(torch.float64)
    p = torch.full((n,), 1.0 / n, dtype=torch.float64, device=m.val.device)
    move = math.inf
    for _ in range(iters):
        y = torch.zeros_like(p).index_add_(0, m.row, m.val * p[m.col])
        q = alpha * (y + torch.dot(dangling, p) / n) + (1.0 - alpha) / n
        move = float((q - p).abs().sum())
        p = q
    return p, move


def l1_gap(p: torch.Tensor, ref: torch.Tensor) -> float:
    """``||p - ref||_1`` in float64; inf where p has another shape or a
    value that is not finite."""
    p = p.to(ref.device, torch.float64)
    if p.shape != ref.shape or not bool(torch.isfinite(p).all()):
        return float("inf")
    return float((p - ref).abs().sum())
