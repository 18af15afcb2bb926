"""Preconditioned CG solves from one caller, one after the other.

Request i solves A x = b for b number ``i % bank`` of a bank of seeded
right-hand sides on the device, from x0 = 0, with ``cg(matvec, b, tol=,
maxiter=, minv=jacobi_preconditioner(...))``. The matvec copies its
vector into one padded x table and runs ``sell_spmv`` on it, as the
package's ``cg_sell`` does. A solve ends on the solver's stop test, which
reads a flag back to the host; its host time is one sample of
``solve_ms_p95``.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness.client import DTYPES, Client as Base, no_span
from benchmark.reference.products import residual


class Client(Base):

    def upload(self, sell):
        self.container = self.port.device_put_sell(
            sell, DTYPES[self.precision], device=self.device)

    def prepare(self):
        self.minv = self.port.jacobi_preconditioner(
            self.csr, torch.float32, device=self.device)
        self.tab = self.port.ops.sell.pack_x_table(
            torch.zeros(self.ncols, device=self.device), self.ncols)
        self.bs = [self.randn(self.nrows, torch.float32)
                   for _ in range(self.bank)]
        self.span = no_span
        self.warm_up()

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        with self.span("matvec"):
            self.tab[: v.shape[0]].copy_(v)
            return self.port.sell_spmv(self.container, self.tab)

    def step(self, i: int, span):
        k = i % self.bank
        self.span = span
        t0 = time.perf_counter()
        with span("cg"):
            x, iters, _ = self.port.cg(
                self.matvec, self.bs[k], tol=float(self.traffic["tol"]),
                maxiter=int(self.traffic["maxiter"]), minv=self.minv)
        self.stats.setdefault("solve_s", []).append(time.perf_counter() - t0)
        self.stats.setdefault("iters", []).append(iters)
        return k, x

    def release(self):
        self.container = self.minv = self.tab = None

    def unfinished(self) -> int:
        """Solves that stopped at ``maxiter`` short of the tolerance."""
        cap = int(self.traffic["maxiter"])
        return sum(1 for k in self.stats.get("iters", ()) if k >= cap)

    def check(self, matrix, item) -> dict:
        k, x = item
        return {"max_residual": residual(matrix, x, self.bs[k])}
