"""A 3-D FEM operator, symmetric and strictly diagonally dominant.

Frozen copy of ``fem_3d`` in ``sparsematrixvectormultiplication_tpu_torch/
models/synthetic.py`` at commit 8449dc1, in torch so that it runs on the
card: nodes on an nx x ny x nz grid with ``dof`` unknowns each, every node
coupled to its 27-neighbourhood by a dense dof x dof block, so a row holds
up to 27 runs of ``dof`` contiguous columns. The pattern, and the order of
the entries, are ``fem_3d``'s; with ``dof`` 3 it is the pattern of an
assembled Q1 (trilinear hexahedron) elasticity operator on a structured
cube, as PETSc's ex56 assembles it, before boundary conditions.

The values are not ``fem_3d``'s normal draws. They are made symmetric and
positive definite as the implicit time step of such a model needs it, and
as the package's smoke made it: entry (i, j) takes a uniform value in
[-1, 1) hashed from (min(i, j), max(i, j)) and the seed, so (i, j) and
(j, i) are equal without a transpose, and every diagonal entry gains the
largest absolute row sum, rounded up, plus 1.
"""

from __future__ import annotations

import math

import torch

from .matrix import Matrix, uniform_of

_OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


def generate(params: dict, seed: int, device) -> Matrix:
    """The operator of ``params`` (``nx``, ``ny``, ``nz``, ``dof``) with
    values from ``seed``, on ``device``."""
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    dof = int(params["dof"])
    nn = nx * ny * nz
    n = nn * dof
    node = torch.arange(nn, dtype=torch.int64, device=device)
    x, y, z = node % nx, (node // nx) % ny, node // (nx * ny)
    rows_l, cols_l = [], []
    for dz, dy, dx in _OFFSETS:
        ok = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
              & (z + dz >= 0) & (z + dz < nz))
        src = node[ok]
        rows_l.append(src)
        cols_l.append(src + (dx + dy * nx + dz * nx * ny))
    nr, nc = torch.cat(rows_l), torch.cat(cols_l)
    del rows_l, cols_l, node, x, y, z
    di = torch.arange(dof, dtype=torch.int64, device=device)
    row = (nr[:, None, None] * dof + di[None, :, None]).expand(
        -1, dof, dof).reshape(-1)
    col = (nc[:, None, None] * dof + di[None, None, :]).expand(
        -1, dof, dof).reshape(-1)
    del nr, nc
    key = torch.minimum(row, col) * n + torch.maximum(row, col)
    val = uniform_of(key, seed)
    del key
    absrow = torch.zeros(n, dtype=torch.float64, device=device)
    absrow.index_add_(0, row, val.abs())
    shift = math.ceil(float(absrow.max())) + 1.0
    val = torch.where(row == col, val + shift, val)
    return Matrix(n, n, row, col, val)
