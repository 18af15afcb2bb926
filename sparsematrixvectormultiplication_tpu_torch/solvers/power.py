"""Power iteration and PageRank over the port's matvecs.

Counterpart of the JAX package's ``solvers/power.py``. PageRank is the
production workload of the scattered-regime matrices (power-law web
graphs): every iteration is one SpMV against a column-stochastic operator
plus vector work. As in :mod:`.cg`, each JAX ``lax.while_loop`` is a Python
loop with the state on the device and one host read, the stop test, per
iteration; iteration counts are Python ``int``. :func:`pagerank` is traced
as :func:`.cg.cg` is (``utils.profiling``); :class:`GraphedPageRank` replays
its iterations from a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..utils.profiling import annotate, count

__all__ = ["power_iteration", "pagerank", "pagerank_operator",
           "GraphedPageRank"]


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
    stops at L1 movement ``<= tol``. :class:`GraphedPageRank` runs the
    same iterations from a CUDA graph.

    Traced (``utils.profiling``): the solve ``solvers.pagerank``, each
    matvec ``solvers.pagerank.matvec``, each iteration's vector work
    ``solvers.pagerank.update``, each stop test
    ``solvers.pagerank.stop_test``, and its host reads in the counter
    ``solvers.pagerank.host_reads``.
    """
    _check_mask(dangling)
    with annotate("solvers.pagerank"):
        n = dangling.shape[0]
        dt = _dtype(dangling)
        p = torch.full((n,), 1.0 / n, dtype=dt, device=dangling.device)
        teleport = (1.0 - alpha) / n
        d = dangling.to(dt)
        delta = torch.tensor(math.inf, dtype=dt, device=p.device)
        k = 0
        while k < maxiter and _moving(delta, tol):
            p, delta = _iteration(matvec, p, d, alpha, teleport)
            k += 1
        return p, k, delta


class GraphedPageRank:
    """:func:`pagerank`'s solves of one operator, each iteration replayed
    from one CUDA graph.

    In :func:`pagerank` every launch of an iteration's matvec and update
    costs host time, and the stop test's read makes the card wait for it:
    on GAP's kron graph at SCALE 20 an H100's host took longer to queue an
    iteration than the card to run it, and the solve's time swung with the
    host's speed. Here one iteration (the matvec, the update and the copy
    of its result into the iterate) is captured once, at construction, on
    the device of ``dangling``; a solve replays it, so an iteration costs
    the host one replay and the stop test's read. ``matvec`` must be
    capturable: device work on the current stream only, no host read, its
    argument read anew each call (a matvec that copies p into an x table it
    holds and calls ``sell_spmv`` is). Off CUDA nothing is captured and a
    solve runs :func:`pagerank`'s loop.

    ``solver(tol=, maxiter=)`` returns :func:`pagerank`'s ``(p, iters,
    delta)`` for the same arguments bit for bit (the same kernels in the
    same order), as new tensors. Traced: the solve ``solvers.pagerank``,
    each replay ``solvers.pagerank.iteration``, each stop test
    ``solvers.pagerank.stop_test`` and the counter
    ``solvers.pagerank.host_reads``.
    """

    def __init__(self, matvec: Callable, dangling: torch.Tensor, *,
                 alpha: float = 0.85):
        _check_mask(dangling)
        self.n = n = dangling.shape[0]
        dt = _dtype(dangling)
        self.matvec, self.alpha = matvec, alpha
        self.teleport = (1.0 - alpha) / n
        self.d = dangling.to(dt)
        self.p = torch.full((n,), 1.0 / n, dtype=dt, device=dangling.device)
        self.delta = torch.full((), math.inf, dtype=dt,
                                device=dangling.device)
        self.graph = (_capture(self._step, dangling.device)
                      if dangling.device.type == "cuda" else None)

    def _step(self):
        q, delta = _iteration(self.matvec, self.p, self.d, self.alpha,
                              self.teleport)
        self.p.copy_(q)
        self.delta.copy_(delta)

    def __call__(self, *, tol: float = 1e-10, maxiter: int = 500):
        with annotate("solvers.pagerank"):
            self.p.fill_(1.0 / self.n)
            self.delta.fill_(math.inf)
            k = 0
            while k < maxiter and _moving(self.delta, tol):
                if self.graph is None:
                    self._step()
                else:
                    with annotate("solvers.pagerank.iteration"):
                        self.graph.replay()
                k += 1
            return self.p.clone(), k, self.delta.clone()


def _capture(step: Callable, device: torch.device):
    """``step()`` captured as a CUDA graph on a side stream, after one call
    on that stream that builds its kernels and fills its caches (the
    recipe of ``torch.cuda.graphs``)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    return graph


def _check_mask(dangling):
    if not isinstance(dangling, torch.Tensor):
        raise TypeError("dangling must be a tensor on the iteration's device, "
                        f"got {type(dangling).__name__}")


def _dtype(dangling: torch.Tensor) -> torch.dtype:
    return (dangling.dtype if dangling.is_floating_point()
            else torch.get_default_dtype())


def _iteration(matvec: Callable, p: torch.Tensor, d: torch.Tensor,
               alpha: float, teleport: float) -> tuple:
    """One power step from ``p``: ``(q, ||q - p||_1)``, the dangling mass
    ``d . p`` spread uniformly."""
    with annotate("solvers.pagerank.matvec"):
        pp = matvec(p).to(p.dtype)
    with annotate("solvers.pagerank.update"):
        leaked = torch.vdot(d, p)
        q = alpha * (pp + leaked / p.shape[0]) + teleport
        return q, torch.sum(torch.abs(q - p))


def _moving(delta: torch.Tensor, tol: float) -> bool:
    """The stop test: ``delta > tol`` read back to the host."""
    with annotate("solvers.pagerank.stop_test"):
        count("solvers.pagerank.host_reads")
        return bool(delta > tol)
