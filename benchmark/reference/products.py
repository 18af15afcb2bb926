"""The plain fp64 reference: products, their row bounds and residuals.

Everything is computed again from the generated coordinates in float64
with plain torch operations (a product per entry, ``index_add_`` per row),
on the device the matrix is on, in blocks of entries so that a block of
right-hand sides fits. Nothing the package under test made is read.

The gap of a computed row is measured against the row's bound
``sum_j |a_ij| |x_j|``: the sum of the magnitudes the row adds up, which
bounds what rounding in any order of summation can do to it.
"""

from __future__ import annotations

import torch

from .matrix import Matrix

BLOCK = 1 << 22  # entries a block: 32 MB of fp64 products a right-hand side


def spmm(m: Matrix, x: torch.Tensor) -> tuple:
    """``(A @ x, |A| @ |x|)`` in float64 for ``x`` of shape (ncols,) or
    (ncols, R)."""
    x = x.to(m.val.device, torch.float64)
    shape = (m.nrows,) + tuple(x.shape[1:])
    y = torch.zeros(shape, dtype=torch.float64, device=x.device)
    bound = torch.zeros_like(y)
    ax = x.abs()
    for s in range(0, m.nnz, BLOCK):
        row, col = m.row[s:s + BLOCK], m.col[s:s + BLOCK]
        v = m.val[s:s + BLOCK]
        if x.ndim == 2:
            v = v[:, None]
        y.index_add_(0, row, v * x[col])
        bound.index_add_(0, row, v.abs() * ax[col])
    return y, bound


def row_gap(m: Matrix, x: torch.Tensor, y: torch.Tensor) -> float:
    """The widest gap of computed ``y`` (≈ A @ x, any float type) from the
    fp64 product, each row's (and column's) gap over its bound; inf where
    y has another shape or a value that is not finite."""
    ref, bound = spmm(m, x)
    y = y.to(ref.device, torch.float64)
    if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
        return float("inf")
    tiny = torch.finfo(torch.float64).tiny
    return float(((y - ref).abs() / bound.clamp_min(tiny)).max())


def residual(m: Matrix, x: torch.Tensor, b: torch.Tensor) -> float:
    """The true relative residual ``||b - A x|| / ||b||`` in float64; inf
    where x has another shape or a value that is not finite."""
    x = x.to(m.val.device, torch.float64)
    b = b.to(m.val.device, torch.float64)
    if x.shape != b.shape or not bool(torch.isfinite(x).all()):
        return float("inf")
    ax, _ = spmm(m, x)
    return float(torch.linalg.vector_norm(b - ax)
                 / torch.linalg.vector_norm(b))
