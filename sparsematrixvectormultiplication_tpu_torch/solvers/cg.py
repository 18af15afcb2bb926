"""Conjugate-gradient solver over the port's SpMV kernels.

Counterpart of the JAX package's ``solvers/cg.py``. There the iteration is
one ``lax.while_loop`` device program; here it is a Python loop of the same
recurrences on tensors: the vector state and the scalars stay on the device
of ``b``, and each iteration reads one boolean back to the host, the stop
test, at the point where the JAX loop tests its condition, so the iteration
counts are JAX's. Iteration counts come back as Python ``int``.

``cg`` takes any matvec ``v -> A @ v``; ``cg_sell`` wires in the port's
device containers: ``DeviceSell`` (:func:`..ops.sell.sell_spmv`, f32 sums),
``DevicePanelSell`` (:func:`..ops.sell.panel_sell_spmv`) and ``DeviceCSR``
(:meth:`..ops.xla.DeviceCSR.spmv`, fp64-capable). CG requires A symmetric
positive-definite.

The solver state has the dtype of ``b``: a matvec that returns another type
(f32 sums under fp64 state) is widened to it, as JAX promotes under x64.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..formats.sell import LANES, slab_table_rows
from ..ops.sell import (DevicePanelSell, DeviceSell, panel_sell_spmv,
                        sell_spmv)
from ..ops.xla import DeviceCSR

__all__ = ["cg", "cg_sell", "cg_multi", "jacobi_preconditioner"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a, b).real


def cg(matvec: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
       maxiter: int = 1000, minv=None, prec: Callable | None = None):
    """Solve ``A @ x = b`` for SPD ``A`` given ``matvec(v) -> A @ v``.

    Preconditioning (the standard PCG recurrences): pass ``minv``, a
    diagonal-inverse tensor (``z = minv * r``; see
    :func:`jacobi_preconditioner`), or ``prec``, any callable applying
    M^-1. Returns ``(x, iters, resnorm)``: ``iters`` a Python ``int``,
    ``resnorm`` a 0-d tensor; stops when ``||r|| <= tol * ||b||`` or after
    ``maxiter``.
    """
    dt = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.to(dt)
    bnorm = torch.sqrt(_dot(b, b))
    atol2 = (tol * bnorm) ** 2
    if minv is not None:
        apply_m = lambda r: r * minv.to(r.dtype)  # noqa: E731
    elif prec is not None:
        apply_m = prec
    else:
        apply_m = lambda r: r  # noqa: E731

    r = b - matvec(x).to(dt)
    z = apply_m(r)
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r)
    k = 0
    while k < maxiter and bool(rr > atol2):
        ap = matvec(p).to(dt)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rr = _dot(r, r)
        k += 1
    return x, k, torch.sqrt(rr)


def jacobi_preconditioner(csr, dtype=None, *, device):
    """Diagonal (Jacobi) inverse ``1 / diag(A)`` of a host CSRMatrix as a
    tensor on ``device``, for ``cg(..., minv=...)``. Zero or missing
    diagonal entries give 1 (identity on those rows). ``dtype`` defaults to
    torch's default dtype (JAX: its default float)."""
    diag = np.zeros(csr.nrows)
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    on_diag = rows == csr.col_idx
    diag[rows[on_diag]] = csr.values[on_diag]
    diag[diag == 0.0] = 1.0
    return torch.as_tensor(1.0 / diag, device=device,
                           dtype=dtype or torch.get_default_dtype())


def cg_multi(matmat: Callable, B: torch.Tensor, X0=None, *, tol: float = 1e-6,
             maxiter: int = 1000):
    """Solve ``A @ X = B`` for ``B`` of shape (n, k): k independent CG
    iterations sharing one multi-RHS matmat per step (``sell_spmm``,
    ``bsr_spmm``).

    Per-column alpha/beta keep the k systems independent; converged columns
    freeze (their updates multiply by 0), so one lagging column never
    perturbs the others. Returns ``(X, iters, resnorms)`` with ``resnorms``
    per column.
    """
    dt = B.dtype
    X = torch.zeros_like(B) if X0 is None else X0.to(dt)
    bnorm2 = torch.sum(B * B, dim=0)
    atol2 = (tol ** 2) * bnorm2

    R = B - matmat(X).to(dt)
    P = R
    rs = torch.sum(R * R, dim=0)
    k = 0
    while k < maxiter and bool(torch.any(rs > atol2)):
        live = rs > atol2                       # per-column freeze mask
        AP = matmat(P).to(dt)
        pap = torch.sum(P * AP, dim=0)
        alpha = torch.where(live, rs / torch.where(pap == 0, 1.0, pap), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        rs_new = torch.sum(R * R, dim=0)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
        P = torch.where(live[None, :], R + beta[None, :] * P, P)
        rs = torch.where(live, rs_new, rs)
        k += 1
    return X, k, torch.sqrt(rs)


def cg_sell(dmat, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
            maxiter: int = 1000):
    """CG with the port's device matvecs.

    ``dmat`` is a :class:`..ops.sell.DeviceSell` or ``DevicePanelSell``
    (the SELL kernels, f32 sums; one padded x table per solve, each search
    direction copied into its head) or a :class:`..ops.xla.DeviceCSR`
    (fp64-capable). ``b`` is a dense 1-D tensor of length ``ncols`` on the
    container's device (= ``nrows``: CG needs a square SPD matrix). A SELL
    uploaded in SELL-C-sigma row order raises ``ValueError``: its y comes
    back permuted, which is not ``A @ x``. CUDA containers launch the
    kernels, CPU ones run their plain versions.
    """
    if not isinstance(dmat, (DeviceSell, DevicePanelSell, DeviceCSR)):
        raise TypeError(f"unsupported device matrix {type(dmat).__name__}")
    if dmat.nrows != dmat.ncols:
        raise ValueError("CG needs a square matrix")
    if getattr(dmat, "sigma_sorted", False):
        raise ValueError("the SELL is in SELL-C-sigma row order: its matvec "
                         "returns permuted rows; convert with "
                         "sigma_sort=False")
    n = b.shape[0]
    if isinstance(dmat, DeviceSell):
        tab = torch.zeros(slab_table_rows(dmat.ncols) * LANES,
                          dtype=torch.float32, device=b.device)

        def matvec(v):
            tab[:n].copy_(v)
            return sell_spmv(dmat, tab)[:n]

    elif isinstance(dmat, DevicePanelSell):
        def matvec(v):
            return panel_sell_spmv(dmat, v.float())[:n]

    else:
        def matvec(v):
            return dmat.spmv(v)[:n]

    return cg(matvec, b, x0, tol=tol, maxiter=maxiter)
