"""PageRank solves from one caller, one after the other.

Each request is one solve of the package's ``GraphedPageRank(matvec,
dangling, alpha=)``, built once at set-up (its iteration captured as a CUDA
graph on the card), called with ``tol=`` and ``maxiter=``: ``pagerank``'s
iterations from the uniform vector, as GAP's ``pr_spmv.cc`` runs them:
damping 0.85, stopping when an iteration moves p by at most 1e-4 in L1, or
after 20 iterations (a solve that stops there is finished, by GAP's rule).
The matvec copies p into one padded x table and runs ``sell_spmv`` on it,
as the PCG client does; ``dangling`` is the f32 mask of the matrix's
columns with no entry. Each solve's host time is one sample of
``solve_ms_p95``. A sampled solve is checked against the fp64 reference
run for as many iterations from the same start (``max_l1_gap``), and its
count against GAP's stop rule: the reference's L1 move in the solve's last
iteration (``stop_move``; 0 where the solve stopped at ``maxiter``) is at
most the tolerance, up to the rounding the solve's f32 move can show.

The package has to convert a heavy-tailed matrix as SELL-C-sigma by itself
(its row-order rule, ``formats/sell_order.py``): with the default binning
GAP's kron graph at SCALE 20 would take some 200 stored slots an entry,
more than the card holds. Importing this module raises where the package
lacks the rule, before anything is generated or converted.
"""

from __future__ import annotations

import importlib
import time

import torch

from benchmark.harness.client import DTYPES, Client as Base
from benchmark.harness.core import PORT
from benchmark.reference.pagerank import iterate, l1_gap

importlib.import_module(PORT + ".formats.sell_order")


class Client(Base):

    def upload(self, sell):
        self.container = self.port.device_put_sell(
            sell, DTYPES[self.precision], device=self.device)

    def prepare(self):
        cols = torch.from_numpy(self.csr.col_idx).to(self.device, torch.int64)
        self.dangling = (torch.bincount(cols, minlength=self.ncols)
                         == 0).to(torch.float32)
        self.tab = self.port.ops.sell.pack_x_table(
            torch.zeros(self.ncols, device=self.device), self.ncols)
        self.refs = {}
        self.solver = self.port.GraphedPageRank(
            self.matvec, self.dangling, alpha=float(self.traffic["alpha"]))
        self.warm_up()

    def matvec(self, p: torch.Tensor) -> torch.Tensor:
        self.tab[: p.shape[0]].copy_(p)
        return self.port.sell_spmv(self.container, self.tab)

    def step(self, i: int, span):
        t0 = time.perf_counter()
        with span("pagerank"):
            p, iters, _ = self.solver(tol=float(self.traffic["tol"]),
                                      maxiter=int(self.traffic["maxiter"]))
        self.stats.setdefault("solve_s", []).append(time.perf_counter() - t0)
        self.stats.setdefault("iters", []).append(iters)
        return iters, p

    def release(self):
        self.container = self.tab = self.solver = None

    def check(self, matrix, item) -> dict:
        iters, p = item
        if iters not in self.refs:
            self.refs[iters] = iterate(matrix, iters,
                                       float(self.traffic["alpha"]))
        ref, move = self.refs[iters]
        stop = 0.0 if iters >= int(self.traffic["maxiter"]) else move
        return {"max_l1_gap": l1_gap(p, ref), "stop_move": stop}
