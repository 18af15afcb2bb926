"""A stream of SpMMs from one caller, dispatched ahead.

Request i multiplies the matrix by X number ``i % bank`` of a bank of
seeded (ncols, R) f32 blocks on the device, through ``device_put_sell``
and ``sell_spmm`` on the raw X: an all-wl SELL reads it in place.
"""

from __future__ import annotations

import torch

from benchmark.harness.client import DTYPES, Client as Base
from benchmark.reference.products import row_gap


class Client(Base):

    @property
    def rhs(self) -> int:
        return int(self.traffic["rhs"])

    def upload(self, sell):
        self.container = self.port.device_put_sell(
            sell, DTYPES[self.precision], device=self.device)

    def prepare(self):
        self.xs = [self.randn((self.ncols, self.rhs), torch.float32)
                   for _ in range(self.bank)]
        self.warm_up()

    def step(self, i: int, span):
        k = i % self.bank
        with span("sell_spmm"):
            return k, self.port.sell_spmm(self.container, self.xs[k])

    def check(self, matrix, item) -> dict:
        k, y = item
        return {"max_row_gap": row_gap(matrix, self.xs[k], y)}
