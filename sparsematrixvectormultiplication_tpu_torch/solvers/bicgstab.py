"""BiCGSTAB: nonsymmetric systems over the port's matvecs.

Counterpart of the JAX package's ``solvers/bicgstab.py``: van der Vorst's
BiCGSTAB with the rho/omega breakdown guards (the iteration stops by flag
when |rho| or |omega| underflows; the returned residual tells the caller).
Two matvecs and vector updates per step, the state on the device of ``b``
and one host read, the stop test, per iteration, where the JAX
``lax.while_loop`` tests its condition.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["bicgstab"]

_EPS = 1e-30


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a, b).real


def _guard(t: torch.Tensor) -> torch.Tensor:
    """``t``, or ``_EPS`` where ``|t| < _EPS``."""
    return torch.where(torch.abs(t) < _EPS, _EPS, t)


def bicgstab(matvec: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
             maxiter: int = 1000):
    """Solve ``A @ x = b`` for general (nonsymmetric) ``A``.

    Returns ``(x, iters, resnorm)`` (``iters`` a Python ``int``); stops at
    ``||r|| <= tol * ||b||``, ``maxiter``, or numerical breakdown
    (stagnating rho/omega).
    """
    dt = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    bnorm = torch.sqrt(_dot(b, b))
    atol2 = (tol * bnorm) ** 2

    r = b - matvec(x).to(dt)
    rhat = r  # shadow residual, fixed
    p = r
    rho = _dot(rhat, r)
    rs = _dot(r, r)
    broke = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool((rs > atol2) & ~broke):
        v = matvec(p).to(dt)
        alpha = rho / _guard(_dot(rhat, v))
        s = r - alpha * v
        t = matvec(s).to(dt)
        tt = _dot(t, t)
        omega = _dot(t, s) / torch.where(tt < _EPS, _EPS, tt)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = _dot(rhat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p = r + beta * (p - omega * v)
        broke = (torch.abs(rho_new) < _EPS) | (torch.abs(omega) < _EPS)
        rho = rho_new
        rs = _dot(r, r)
        k += 1
    return x, k, torch.sqrt(rs)
