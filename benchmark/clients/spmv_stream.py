"""A stream of SpMVs from one caller, dispatched ahead.

Request i multiplies the matrix by x number ``i % bank`` of a bank of
seeded vectors on the device, each request taking its x as new: f32 and
bf16 values through ``device_put_sell`` and ``sell_spmv``, the x copied
into one padded x table (``pack_x_table``) on every call, as the package's
``cg_sell`` does; double-double through ``device_put_sell_dd`` and
``sell_spmv_dd_f64`` on fp64 x, which prepares its x tables itself. No
request reads anything back to the host, so the caller runs ahead until
the launch queue is full.
"""

from __future__ import annotations

import torch

from benchmark.harness.client import DTYPES, X_DTYPES, Client as Base
from benchmark.reference.products import row_gap


class Client(Base):

    def upload(self, sell):
        if self.precision == "dd":
            self.container = self.port.device_put_sell_dd(
                sell, device=self.device)
        else:
            self.container = self.port.device_put_sell(
                sell, DTYPES[self.precision], device=self.device)

    def prepare(self):
        dtype = X_DTYPES[self.traffic["x"]]
        self.xs = [self.randn(self.ncols, dtype) for _ in range(self.bank)]
        if self.precision != "dd":
            self.tab = self.port.ops.sell.pack_x_table(
                torch.zeros(self.ncols, device=self.device), self.ncols)
        self.warm_up()

    def step(self, i: int, span):
        k = i % self.bank
        if self.precision == "dd":
            with span("sell_spmv_dd_f64"):
                return k, self.port.sell_spmv_dd_f64(self.container,
                                                     self.xs[k])
        with span("sell_spmv"):
            self.tab[: self.ncols].copy_(self.xs[k])
            return k, self.port.sell_spmv(self.container, self.tab)

    def release(self):
        self.container = self.tab = None

    def check(self, matrix, item) -> dict:
        k, y = item
        return {"max_row_gap": row_gap(matrix, self.xs[k], y)}
