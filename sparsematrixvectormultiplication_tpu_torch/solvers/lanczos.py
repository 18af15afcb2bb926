"""Lanczos tridiagonalization and extremal-eigenvalue estimation.

Counterpart of the JAX package's ``solvers/lanczos.py``. The m-step Lanczos
process is the canonical consumer of a fast symmetric SpMV: every step is
one matvec plus vector work. Extremal Ritz values converge far faster than
power iteration (:mod:`.power`) and give tighter spectral bounds for the
Chebyshev preconditioner than Gershgorin discs (:mod:`.chebyshev`).

The JAX ``lax.scan`` of ``m`` fixed steps is a Python loop of ``m`` steps
with no host read at all: the basis ``V`` (``(m, n)``), the alphas and the
betas stay on the device of ``v0``. Full reorthogonalization projects the
whole stored basis out each step (one ``(m, n) @ (n,)`` product and its
transpose).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.linalg as sla
import torch

__all__ = ["lanczos", "lanczos_extremal", "lanczos_bounds"]


def lanczos(matvec: Callable, v0: torch.Tensor, *, m: int = 30,
            reorth: bool = True):
    """m-step Lanczos: ``A @ V[:k] ≈ V[:k] @ T`` with T tridiagonal.

    ``matvec`` is the symmetric operator ``v -> A @ v``; ``v0`` any nonzero
    start vector; ``reorth`` reorthogonalizes against the stored basis each
    step (off, the three-term recurrence loses orthogonality once Ritz
    values converge). A step whose new vector vanishes (an invariant
    subspace) keeps the basis vector instead of dividing by ~0.

    Returns ``(alpha, beta, V)``: diagonal ``alpha (m,)``, off-diagonal
    ``beta (m,)`` (``beta[m-1]`` is the residual norm of the last step) and
    the basis ``V (m, n)``, in ``v0``'s dtype on its device.
    """
    n = v0.shape[0]
    dt = v0.dtype
    tiny = 10 * torch.finfo(dt).eps
    v = v0 / torch.linalg.norm(v0)
    V = torch.zeros((m, n), dtype=dt, device=v0.device)
    V[0] = v
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=dt, device=v0.device)
    alphas, betas = [], []
    for k in range(m):
        w = matvec(v).to(dt)
        alpha = torch.vdot(v, w)
        w = w - alpha * v - beta_prev * v_prev
        if reorth:
            # project out the whole stored basis (rows >= k+1 are zero)
            coeffs = V @ w
            w = w - V.T @ coeffs
        beta = torch.linalg.norm(w)
        # breakdown (invariant subspace found): keep the basis frozen
        safe = beta > tiny * torch.abs(alpha)
        v_next = torch.where(safe, w / torch.where(safe, beta, 1.0), v)
        if k + 1 < m:
            V[k + 1] = v_next
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v, beta_prev = v, v_next, beta
    return torch.stack(alphas), torch.stack(betas), V


def lanczos_extremal(matvec: Callable, v0: torch.Tensor, *, m: int = 30,
                     reorth: bool = True):
    """Extremal eigenvalue estimates ``(lmin, lmax)`` of symmetric A, as
    Python floats.

    Runs m Lanczos steps and takes the extremal eigenvalues of the
    tridiagonal Rayleigh quotient (host-side ``eigh_tridiagonal`` on the
    tiny (m, m) system: the device does only the m SpMVs).
    """
    alphas, betas, _ = lanczos(matvec, v0, m=m, reorth=reorth)
    a = alphas.cpu().numpy().astype(np.float64)
    b = betas.cpu().numpy().astype(np.float64)[:-1]
    # a breakdown step freezes the recurrence; truncate T there so the
    # repeated frozen alphas don't duplicate Ritz values
    eps = np.finfo(np.float64).eps
    cut = np.nonzero(b <= 10 * eps * np.abs(a[:-1]))[0]
    if cut.size:
        k = int(cut[0]) + 1
        a, b = a[:k], b[: k - 1]
    w = sla.eigh_tridiagonal(a, b, eigvals_only=True)
    return float(w[0]), float(w[-1])


def lanczos_bounds(matvec: Callable, n: int, *, m: int = 30, seed: int = 0,
                   dtype=torch.float32, safety: float = 1.05, device):
    """Chebyshev-ready spectral bounds from a short Lanczos run.

    An alternative to :func:`.chebyshev.gershgorin_bounds` that needs only
    the operator: the start vector is ``numpy.random.default_rng(seed)``'s
    standard normal, in ``dtype`` on ``device``. Returns ``(lmin, lmax)``
    with a multiplicative ``safety`` margin on ``lmax`` and the matching
    division on ``lmin`` (Ritz values under-estimate the true extremes).
    ``lmin`` is floored at ``lmax / 1e6`` so the bounds stay usable for
    indefinite-looking estimates on nearly-singular SPD operators.
    """
    rng = np.random.default_rng(seed)
    v0 = torch.as_tensor(rng.standard_normal(n), device=device).to(dtype)
    lmin, lmax = lanczos_extremal(matvec, v0, m=m)
    lmax = lmax * safety
    lmin = max(lmin / safety, lmax / 1e6)
    return lmin, lmax
