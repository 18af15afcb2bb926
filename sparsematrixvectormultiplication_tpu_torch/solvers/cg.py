"""Conjugate-gradient solver over the port's SpMV kernels.

Counterpart of the JAX package's ``solvers/cg.py``. There the iteration is
one ``lax.while_loop`` device program; here it is a Python loop of the same
recurrences on tensors: the vector state and the scalars stay on the device
of ``b``, and each iteration reads one boolean back to the host, the stop
test, at the point where the JAX loop tests its condition, so the iteration
counts are JAX's. Iteration counts come back as Python ``int``.

``cg`` has two paths with the same recurrences, stop rule and return
contract. On the card (``b`` a contiguous 1-D CUDA float32 or float64
tensor, ``minv`` None or a tensor of ``b``'s shape, no ``prec``) the fused
path runs each iteration's vector update, dot products and stop-test
comparison as three hand-written kernels (:mod:`..ops.cg_step`,
``csrc/cg_step.cu``) with the scalars in a device workspace. Otherwise (the
CPU, a ``prec`` callable, other inputs) the eager loop runs them as PyTorch
ops; it is also the plain version the card tests hold the fused path to.

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
from ..ops import cg_step as CS
from ..ops.sell import (DevicePanelSell, DeviceSell, panel_sell_spmv,
                        sell_spmv)
from ..ops.xla import DeviceCSR
from ..utils.profiling import annotate, count

__all__ = ["cg", "cg_sell", "cg_multi", "jacobi_preconditioner"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a, b).real


def _unconverged(rr: torch.Tensor, atol2: torch.Tensor) -> bool:
    """The stop test: ``rr > atol2`` read back to the host."""
    with annotate("solvers.cg.stop_test"):
        count("solvers.cg.host_reads")
        return bool(rr > atol2)


def _fused_unconverged(w: CS.CGWork) -> bool:
    """The fused path's stop test: the flag its kernels wrote, read back."""
    with annotate("solvers.cg.stop_test"):
        count("solvers.cg.host_reads")
        return CS.cg_unconverged(w)


def _eager_reason(b: torch.Tensor, x0=None, minv=None,
                 prec: Callable | None = None) -> str | None:
    """Why :func:`cg` runs the eager loop for these inputs, or None where it
    runs the fused kernels: "prec" (a preconditioner callable), "dtype"
    (``b`` not float32 or float64), "layout" (``b`` not a contiguous
    vector), "minv" or "x0" (not a tensor of ``b``'s shape and device),
    "device" (``b`` not on a CUDA device)."""
    if prec is not None:
        return "prec"
    if b.dtype not in (torch.float32, torch.float64):
        return "dtype"
    if b.dim() != 1 or not b.is_contiguous():
        return "layout"
    for name, t in (("minv", minv), ("x0", x0)):
        if t is not None and not (isinstance(t, torch.Tensor)
                                  and t.shape == b.shape
                                  and t.device == b.device):
            return name
    if b.device.type != "cuda":
        return "device"
    return None


def cg(matvec: Callable, b: torch.Tensor, x0=None, *, tol: float = 1e-6,
       maxiter: int = 1000, minv=None, prec: Callable | None = None):
    """Solve ``A @ x = b`` for SPD ``A`` given ``matvec(v) -> A @ v``.

    Preconditioning (the standard PCG recurrences): pass ``minv``, a
    diagonal-inverse tensor (``z = minv * r``; see
    :func:`jacobi_preconditioner`), or ``prec``, any callable applying
    M^-1. Returns ``(x, iters, resnorm)``: ``iters`` a Python ``int``,
    ``resnorm`` a 0-d tensor; stops when ``||r|| <= tol * ||b||`` or after
    ``maxiter``.

    The path follows the inputs (:func:`_eager_reason`): a contiguous 1-D
    CUDA ``b`` of float32 or float64 with ``minv`` None or a tensor of its
    shape (cast once a solve to ``b``'s dtype) and no ``prec`` takes the
    fused kernels (:func:`_cg_fused`: three launches and one flag read an
    iteration besides the matvec, which it queues ahead of the read);
    anything else the eager loop (:func:`_cg_eager`). Both test the stop
    rule at the head of the loop, so their iteration counts are the same.
    The eager loop calls ``matvec`` ``iters + 1`` times; the fused path
    calls it once more where it stops on the test (``iters + 2``, the last
    product dropped), as often where it stops at ``maxiter``.

    Traced (``utils.profiling``): the solve ``solvers.cg``, each matvec
    ``solvers.cg.matvec``, each iteration's vector updates
    ``solvers.cg.update`` (the fused launches on that path), each stop test
    ``solvers.cg.stop_test``, its host reads in the counter
    ``solvers.cg.host_reads``, and the iterations the fused kernels ran in
    ``solvers.cg.fused_iters``.
    """
    with annotate("solvers.cg"):
        if _eager_reason(b, x0, minv, prec) is None:
            return _cg_fused(matvec, b, x0, tol, maxiter, minv)
        return _cg_eager(matvec, b, x0, tol, maxiter, minv, prec)


def _cg_eager(matvec, b, x0, tol, maxiter, minv, prec):
    """:func:`cg` as PyTorch ops: about 17 launches an iteration."""
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

    with annotate("solvers.cg.matvec"):
        ax = matvec(x).to(dt)
    r = b - ax
    z = apply_m(r)
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r)
    k = 0
    while k < maxiter and _unconverged(rr, atol2):
        with annotate("solvers.cg.matvec"):
            ap = matvec(p).to(dt)
        with annotate("solvers.cg.update"):
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


def _state(v: torch.Tensor, dt) -> torch.Tensor:
    """A matvec's output as the fused kernels read it."""
    if v.dtype != dt:
        v = v.to(dt)
    return v if v.is_contiguous() else v.contiguous()


def _cg_fused(matvec, b, x0, tol, maxiter, minv):
    """:func:`cg` on the kernels of :mod:`..ops.cg_step`: the device guard,
    the stream and the workspace taken once a solve. Each iteration's matvec
    is called before the stop test that heads it reads its flag, so the
    host's matvec work overlaps the card's: a solve that stops on the test
    calls the matvec once more than the eager loop and drops that product.
    A solve that leaves without reading its last flag (at ``maxiter``, or on
    an exception) waits for it before its workspace is freed
    (:func:`..ops.cg_step.cg_settle`)."""
    with torch.cuda.device(b.device):
        w = CS.CGWork(b, x0, minv, tol)
        try:
            k = _fused_iterations(w, matvec, maxiter)
        finally:
            CS.cg_settle(w)
        return w.x, k, w.resnorm()


def _fused_iterations(w: CS.CGWork, matvec, maxiter: int) -> int:
    """The fused path's loop over ``w``; returns the iterations run."""
    dt = w.dtype
    with annotate("solvers.cg.matvec"):
        ax = _state(matvec(w.x), dt)
    CS.cg_init(w, ax)
    k = 0
    while k < maxiter:
        # the product of the direction the stop test may not need is queued
        # before the test's read, so the card runs it while the host reads;
        # a solve that stops drops it
        with annotate("solvers.cg.matvec"):
            ap = _state(matvec(w.p), dt)
        if not _fused_unconverged(w):
            break
        with annotate("solvers.cg.update"):
            CS.cg_alpha(w, ap)
            CS.cg_step(w, ap)
            CS.cg_dir(w)
        count("solvers.cg.fused_iters")
        k += 1
    return k


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
