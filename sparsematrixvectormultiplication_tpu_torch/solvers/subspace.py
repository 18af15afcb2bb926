"""Block subspace (orthogonal) iteration: top-k eigenpairs via SpMM.

Counterpart of the JAX package's ``solvers/subspace.py``.
:func:`.power.power_iteration` finds the single dominant eigenpair with one
SpMV per step; subspace iteration finds the top ``k``: iterate ``Q <-
orth(A @ Q)`` and read the eigenvalues off the Rayleigh quotient ``Q^T A
Q``. Each step's dominant cost is one multi-RHS SpMM over all k basis
vectors (``sell_spmm``, ``bsr_spmm``): A is streamed once per step instead
of k times.

A step is one matmat, one thin QR (``torch.linalg.qr`` on the (n, k) tall
matrix) and the block-residual stop test, the one host read of the step,
where the JAX ``lax.while_loop`` tests its condition.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["subspace_iteration"]


def _rayleigh(Q: torch.Tensor, AQ: torch.Tensor) -> torch.Tensor:
    H = Q.T @ AQ
    return 0.5 * (H + H.T)


def _block_res(Q: torch.Tensor, AQ: torch.Tensor,
               H: torch.Tensor) -> torch.Tensor:
    num = torch.linalg.norm(AQ - Q @ H)
    return num / torch.clamp_min(torch.linalg.norm(AQ), 1e-300)


def subspace_iteration(matmat: Callable, Q0: torch.Tensor, *,
                       tol: float = 1e-9, maxiter: int = 300):
    """Top-k eigenpairs of symmetric ``A`` given ``matmat(V) -> A @ V``.

    ``Q0``: (n, k) starting block (e.g. random normal); it is
    orthonormalized internally. Returns ``(eigvals, Q, iters, res)``:
    ``eigvals`` the k Ritz values (descending ``|.|``), ``Q`` the (n, k)
    orthonormal Ritz basis, ``iters`` a Python ``int`` and ``res`` the final
    relative block residual ``||A Q - Q H||_F / ||A Q||_F`` (``H = Q^T A
    Q``), converged when ``res <= tol``. The residual test is honest for
    clustered eigenvalues, where Ritz-value drift goes quiet long before the
    subspace has converged.

    The j-th pair converges by ``|λ_{k+1}/λ_j|`` a step, so this wants a
    spectral gap below the sought block. For nonsymmetric ``A`` the Ritz
    values still converge to the dominant eigenvalue moduli but lose their
    variational meaning.
    """
    dt = Q0.dtype
    Q, _ = torch.linalg.qr(Q0)
    AQ = matmat(Q).to(dt)
    H = _rayleigh(Q, AQ)
    it = 0
    while it < maxiter and bool(_block_res(Q, AQ, H) > tol):
        Q, _ = torch.linalg.qr(AQ)
        AQ = matmat(Q).to(dt)
        H = _rayleigh(Q, AQ)
        it += 1
    w = torch.linalg.eigvalsh(H)
    w = w[torch.argsort(-torch.abs(w))]
    return w, Q, it, _block_res(Q, AQ, H)
