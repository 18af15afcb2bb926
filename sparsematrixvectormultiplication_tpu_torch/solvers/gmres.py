"""Restarted GMRES(m): general nonsymmetric systems over the port's matvecs.

Counterpart of the JAX package's ``solvers/gmres.py``: GMRES minimizes the
residual over the full Krylov subspace, the standard choice where
BiCGSTAB's irregular convergence is a problem. Each Arnoldi step orthogonalizes
the new vector against the basis by modified Gram-Schmidt as two
full-basis products, with one re-orthogonalization pass, and the Hessenberg
least-squares problem is carried by Givens rotations, so the in-cycle
residual is ``|g[j+1]|`` with no extra matvec.

Where the data live: the basis ``V`` (``(m+1, n)``) and ``w`` stay on the
device of ``b``; each step reads its Hessenberg column back (one host read
a step, the stop test's), and the rotations, ``g`` and the final triangular
solve run on the host in numpy of the solve's dtype: the same IEEE
operations in the same order as the JAX loop, without queueing O(m^2) tiny
device ops a cycle. A step after the cycle has converged (or broken down)
changes nothing in the JAX loop, so here the cycle ends there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.linalg as sla
import torch

__all__ = ["gmres"]

_EPS = 1e-30


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.vdot(v, v).real)


def _np_dtype(dt: torch.dtype):
    return torch.empty((), dtype=dt).numpy().dtype


def _cycle(matvec, x0, r0, m, atol):
    """One GMRES(m) cycle from residual ``r0``; ``atol`` a numpy scalar of
    the solve's dtype. Returns (x, resnorm, steps)."""
    n = r0.shape[0]
    dt = r0.dtype
    nt = _np_dtype(dt).type
    eps = nt(_EPS)
    beta_d = _norm(r0)
    beta = nt(beta_d.item())
    V = torch.zeros((m + 1, n), dtype=dt, device=r0.device)
    V[0] = r0 / torch.clamp_min(beta_d, _EPS)
    H = np.zeros((m + 1, m), nt)            # rotated columns (R factor + 0s)
    cs = np.zeros(m, nt)
    sn = np.zeros(m, nt)
    g = np.zeros(m + 1, nt)
    g[0] = beta
    active = bool(beta > atol)              # x0 may already be converged
    steps = 0
    for j in range(m):
        if not active:
            break
        Vj = V[: j + 1]
        w = matvec(V[j]).to(dt)
        h = Vj @ w
        w = w - h @ Vj
        # one re-orthogonalization pass (classical GS is unstable unrepeated)
        h2 = Vj @ w
        w = w - h2 @ Vj
        h = h + h2
        hj1_d = _norm(w)
        V[j + 1] = w / torch.clamp_min(hj1_d, _EPS)
        hcol = np.zeros(m + 1, nt)
        hcol[: j + 2] = torch.cat([h, hj1_d[None]]).cpu().numpy()
        hj1 = hcol[j + 1]
        # apply the j previous Givens rotations to the new column
        for i in range(j):
            hi, hi1 = hcol[i], hcol[i + 1]
            hcol[i] = cs[i] * hi + sn[i] * hi1
            hcol[i + 1] = -sn[i] * hi + cs[i] * hi1
        # new rotation annihilating hcol[j+1]
        denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        c = hcol[j] / max(denom, eps) if denom > eps else nt(1.0)
        s = hcol[j + 1] / max(denom, eps) if denom > eps else nt(0.0)
        hcol[j] = c * hcol[j] + s * hcol[j + 1]
        hcol[j + 1] = 0.0
        gj = g[j]
        g[j] = c * gj
        g[j + 1] = -s * gj
        H[:, j] = hcol
        cs[j] = c
        sn[j] = s
        steps += 1
        # converged or happy breakdown (hj1 ~ 0): the later steps are frozen
        active = bool(abs(g[j + 1]) > atol) and bool(hj1 > eps * 10)

    # R y = g over the taken leading block; untaken columns get an identity
    # diagonal and zero rhs, so y vanishes there
    taken = np.arange(m) < steps
    R = np.where(taken[None, :] | taken[:, None], H[:m, :],
                 np.eye(m, dtype=nt))
    R = R + np.where(np.abs(np.diagonal(R)) < eps, eps, nt(0.0)) \
        * np.eye(m, dtype=nt)
    rhs = np.where(taken, g[:m], nt(0.0))
    y = sla.solve_triangular(R, rhs, lower=False).astype(nt)
    x = x0 + torch.from_numpy(y).to(r0.device) @ V[:m]
    return x, abs(g[min(steps, m)]), steps


def gmres(matvec: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
          restart: int = 32, maxiter: int = 1000):
    """Solve ``A @ x = b`` for general ``A`` given ``matvec(v) -> A @ v``.

    Returns ``(x, iters, resnorm)`` (``iters`` a Python ``int``); stops when
    ``||r|| <= tol * ||b||`` or after ``maxiter`` total Arnoldi steps.
    ``restart`` is the cycle length ``m`` (an ``(m+1, n)`` basis on the
    device).
    """
    dt = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    m = int(restart)
    atol_d = (tol * _norm(b)).to(dt)
    atol = _np_dtype(dt).type(atol_d.item())

    r = b - matvec(x).to(dt)
    k = 0
    while k < maxiter and bool(_norm(r) > atol_d):
        x, _, steps = _cycle(matvec, x, r, m, atol)
        r = b - matvec(x).to(dt)  # recomputed: restarts must not inherit drift
        k += max(steps, 1)
    return x, k, _norm(r)
