"""Power iteration and PageRank over the port's matvecs.

Counterpart of the JAX package's ``solvers/power.py``. PageRank is the
production workload of the scattered-regime matrices (power-law web
graphs): every iteration is one SpMV against a column-stochastic operator
plus vector work. As in :mod:`.cg`, each JAX ``lax.while_loop`` is a Python
loop with the state on the device and one host read, the stop test, per
iteration; iteration counts are Python ``int``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = ["power_iteration", "pagerank", "pagerank_operator"]


def power_iteration(matvec: Callable, v0: torch.Tensor, *, tol: float = 1e-9,
                    maxiter: int = 1000):
    """Dominant eigenpair of ``A`` by normalized power iteration.

    Returns ``(eigval, v, iters)``: ``eigval`` a 0-d tensor of ``v0``'s
    dtype, ``iters`` a Python ``int``; stops when the iterate moves less
    than ``tol`` in 2-norm (sign-aligned) or at ``maxiter``.
    """
    dt = v0.dtype
    v = v0 / torch.linalg.norm(v0)
    lam = torch.zeros((), dtype=dt, device=v.device)
    delta = torch.tensor(math.inf, dtype=dt, device=v.device)
    k = 0
    while k < maxiter and bool(delta > tol):
        w = matvec(v).to(dt)
        lam = torch.vdot(v, w).real
        wn = torch.linalg.norm(w)
        # breakdown guard: A @ v exactly zero (nilpotent A, v in the
        # nullspace) would make w / wn NaN; keep v, report lam = 0 and
        # delta = 0 (a clean stop)
        broke = wn == 0
        w = torch.where(broke, v, w / torch.where(broke, 1.0, wn))
        w = torch.where(torch.vdot(w, v).real < 0, -w, w)  # sign-align
        lam = torch.where(broke, 0.0, lam)
        delta = torch.where(broke, 0.0, torch.linalg.norm(w - v))
        v = w
        k += 1
    return lam, v, k


def pagerank_operator(csr, dtype=np.float64):
    """Column-stochastic transition data for :func:`pagerank`.

    Returns ``(csr_t_scaled, dangling)``: ``A^T`` with each original row's
    entries scaled by its weighted out-degree (so ``csr_t_scaled.spmv(p)``
    is ``P @ p`` of the weighted random-surfer chain), plus the
    dangling-node mask (numpy). Edge weights must be non-negative. Host
    side, on :meth:`..formats.csr.CSRMatrix.transpose`; upload the result
    to any kernel layout.
    """
    if np.any(csr.values < 0):
        raise ValueError("pagerank_operator needs non-negative edge "
                         "weights (got negative values; pass |A|)")
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    out_w = np.bincount(rows, weights=csr.values,
                        minlength=csr.nrows).astype(dtype)
    dangling = out_w == 0
    t = csr.transpose()
    # scale every entry by 1/out_weight of its original row = t's column
    vals = t.values / np.where(out_w[t.col_idx] == 0, 1.0, out_w[t.col_idx])
    t = type(t)(t.nrows, t.ncols, t.row_ptr, t.col_idx, vals.astype(dtype))
    return t, dangling


def pagerank(matvec: Callable, dangling: torch.Tensor, *, alpha: float = 0.85,
             tol: float = 1e-10, maxiter: int = 500):
    """PageRank by power iteration on the Google matrix.

    ``matvec(p) -> P @ p`` is the column-stochastic transition operator
    (from :func:`pagerank_operator`, through any kernel of the port);
    ``dangling`` is its mask as a tensor on the device the iteration runs
    on. ``p`` takes ``dangling``'s dtype when it is a floating 0/1 mask,
    else torch's default dtype (JAX: its default float). Returns ``(p,
    iters, delta)`` with ``p`` summing to 1 and ``iters`` a Python ``int``;
    stops at L1 movement ``<= tol``.
    """
    if not isinstance(dangling, torch.Tensor):
        raise TypeError("dangling must be a tensor on the iteration's device, "
                        f"got {type(dangling).__name__}")
    n = dangling.shape[0]
    dt = (dangling.dtype if dangling.is_floating_point()
          else torch.get_default_dtype())
    p = torch.full((n,), 1.0 / n, dtype=dt, device=dangling.device)
    teleport = (1.0 - alpha) / n
    d = dangling.to(dt)
    delta = torch.tensor(math.inf, dtype=dt, device=p.device)
    k = 0
    while k < maxiter and bool(delta > tol):
        leaked = torch.vdot(d, p)  # dangling mass redistributes uniformly
        q = alpha * (matvec(p).to(dt) + leaked / n) + teleport
        delta = torch.sum(torch.abs(q - p))
        p = q
        k += 1
    return p, k, delta
