"""Chebyshev polynomial preconditioning and smoothing over the port's
matvecs.

Counterpart of the JAX package's ``solvers/chebyshev.py``. A polynomial
preconditioner ``M^-1 = p_m(A)``, with ``p_m`` the degree-``m`` Chebyshev
polynomial minimizing ``max_{λ∈[lmin,lmax]} |1 - λ p(λ)|``, costs ``m``
SpMVs an application, needs no new data structure, and is an SPD linear
operator, so it is a valid PCG preconditioner; the triangular solves of
ILU(0), SSOR or Gauss-Seidel are sequential recurrences instead.

The recurrence is Saad, *Iterative Methods for Sparse Linear Systems*, 2nd
ed., Alg. 12.1 (Chebyshev acceleration for ``A z = r``, ``z0 = 0``). The
scalar chain ``rho_k`` depends only on ``(lmin, lmax)``, so it is
precomputed on the host as Python floats and an application is a fixed
chain of matvec + axpy on tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = [
    "gershgorin_bounds",
    "chebyshev_coefficients",
    "chebyshev_preconditioner",
    "chebyshev_smooth",
]


def gershgorin_bounds(csr, floor_ratio: float = 30.0):
    """Host-side spectral-interval estimate for an SPD ``CSRMatrix``.

    Upper bound: Gershgorin, ``lmax <= max_i sum_j |a_ij|`` (never
    underestimates, so the Chebyshev interval covers the spectrum's top).
    Lower bound: the smoother convention ``lmin = lmax / floor_ratio``
    (hypre/AMG use ratios 10-30): Chebyshev preconditioning only needs the
    interval to cover the bulk of the spectrum. Returns ``(lmin, lmax)`` as
    Python floats.
    """
    counts = np.diff(csr.row_ptr)
    rows = np.repeat(np.arange(csr.nrows), counts)
    row_abs = np.bincount(rows, weights=np.abs(csr.values),
                          minlength=csr.nrows)
    lmax = float(row_abs.max()) if row_abs.size else 1.0
    if lmax <= 0.0:
        lmax = 1.0
    return lmax / floor_ratio, lmax


def chebyshev_coefficients(lmin: float, lmax: float, degree: int):
    """The ``rho_k`` scalar chain of Saad Alg. 12.1.

    Returns ``(theta, delta, [rho_1 .. rho_degree])`` as Python floats;
    ``rho_1`` is ``1/sigma1`` by convention (the first step has no
    predecessor).
    """
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if not (0.0 < lmin < lmax):
        raise ValueError(f"need 0 < lmin < lmax, got ({lmin}, {lmax})")
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    rhos = [1.0 / sigma1]
    for _ in range(degree - 1):
        rhos.append(1.0 / (2.0 * sigma1 - rhos[-1]))
    return theta, delta, rhos


def chebyshev_preconditioner(matvec: Callable, lmin: float, lmax: float,
                             degree: int = 4) -> Callable:
    """Return ``apply(r) -> p_m(A) r ~= A^-1 r`` for PCG's ``prec=``.

    ``degree - 1`` matvecs per application (the first step is ``r /
    theta``); degree 3-5 is the usual sweet spot. The result has the dtype
    of ``r`` (a matvec's f32 sums widen to it).
    """
    theta, delta, rhos = chebyshev_coefficients(lmin, lmax, degree)

    def apply(r):
        # k = 1: z1 = r / theta
        d = r * (1.0 / theta)
        z = d
        rho_prev = rhos[0]
        for rho in rhos[1:]:
            resid = r - matvec(z)
            d = (rho * rho_prev) * d + (2.0 * rho / delta) * resid
            z = z + d
            rho_prev = rho
        return z

    return apply


def chebyshev_smooth(matvec: Callable, b, x0=None, *, lmin: float,
                     lmax: float, degree: int = 4):
    """Standalone Chebyshev iteration: ``degree`` steps toward ``A x = b``
    from ``x0`` (or 0). The classic multigrid smoother; also a cheap
    stationary solver on well-conditioned systems. Unlike
    :func:`chebyshev_preconditioner` this handles ``x0 != 0`` by smoothing
    the residual system ``A e = b - A x0``."""
    if x0 is None:
        return chebyshev_preconditioner(matvec, lmin, lmax, degree)(b)
    r0 = b - matvec(x0)
    return x0 + chebyshev_preconditioner(matvec, lmin, lmax, degree)(r0)
