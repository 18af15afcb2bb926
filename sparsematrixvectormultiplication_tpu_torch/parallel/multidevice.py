"""Multi-device SELL SpMV from one process: a SELL shard on each device.

Counterpart of the JAX package's ``parallel/multidevice.py``. Rows are split
into contiguous group ranges balanced by nnz
(:func:`.scheduler.balanced_partition`, the device-level generalization of
the reference's per-thread nnz balancing, csr_matrix.c:167-266); each range
is converted to SELL on its own and uploaded to ``devices[i % n]``; one call
launches every shard's kernels (:func:`..ops.sell.sell_spmv`) before it
reads any y, so the devices run at once, and gathers y on the first shard's
device. No process group is involved (``spmd_pallas.py`` is the
one-process-per-rank form).

The JAX function takes ``sell_kwargs={"sigma_sort": True}`` and then
concatenates each shard's y in its sorted row order, a wrong y. This one
refuses ``sigma_sort``, as ``build_spmd_sell`` does in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.sell import GROUP_ROWS, SellMatrix
from ..ops.sell import device_put_sell, device_put_x, sell_spmv
from .scheduler import balanced_partition

__all__ = ["MultiDeviceSell", "shard_sell_rows"]


class MultiDeviceSell:
    """Per-device SELL shards over contiguous row ranges."""

    def __init__(self, shards, row_starts, nrows, ncols, nnz, dtype):
        self.shards = shards          # [(device, DeviceSell)]
        self.row_starts = row_starts  # (n+1,) global row offsets per shard
        self.nrows = nrows
        self.ncols = ncols
        self.nnz = nnz
        self.dtype = dtype

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def spmv(self, x) -> torch.Tensor:
        """y = A @ x across all shards, as an f32 tensor on the first
        shard's device. ``x`` (host array or tensor) goes to every device;
        every shard's kernels are queued before any y is read."""
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        ys = [sell_spmv(dsell, device_put_x(x, self.ncols, device=device))
              for device, dsell in self.shards]
        first = self.shards[0][0]
        return torch.cat([y.to(first) for y in ys])


def _default_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("shard_sell_rows runs on the GPUs and "
                           "torch.cuda.is_available() is false; pass "
                           "devices=[torch.device('cpu')] * n for the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_sell_rows(
    csr: CSRMatrix,
    devices=None,
    *,
    dtype=torch.float32,
    sell_kwargs=None,
) -> MultiDeviceSell:
    """Split a CSR matrix into per-device row shards (group-aligned,
    nnz-balanced) and upload each as an independent SELL structure.
    ``devices`` defaults to every GPU; a device may appear more than once.
    ``sell_kwargs`` go to :meth:`SellMatrix.from_csr`, but ``sigma_sort``
    raises ``ValueError``: a shard's y would come back in its sorted row
    order."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _default_devices())]
    sell_kwargs = dict(sell_kwargs or {})
    if sell_kwargs.get("sigma_sort"):
        raise ValueError("sigma_sort permutes each shard's rows, and the "
                         "shards' y would be joined in that order; sort "
                         "before sharding instead")

    num_groups = -(-csr.nrows // GROUP_ROWS) if csr.nrows else 0
    n_dev = max(1, min(len(devices), max(num_groups, 1)))

    # nnz per group -> balanced contiguous group ranges per device
    row_nnz = np.zeros(num_groups * GROUP_ROWS, dtype=np.int64)
    row_nnz[: csr.nrows] = csr.row_nnz()
    group_nnz = row_nnz.reshape(num_groups, GROUP_ROWS).sum(axis=1) if num_groups else np.zeros(0, np.int64)
    part = balanced_partition(group_nnz, n_dev)

    shards = []
    row_starts = [0]
    for i, (gs, ge, _load) in enumerate(part):
        r0 = gs * GROUP_ROWS
        r1 = min(ge * GROUP_ROWS, csr.nrows)
        # slice the CSR rows [r0, r1)
        p0, p1 = int(csr.row_ptr[r0]), int(csr.row_ptr[r1])
        sub = CSRMatrix(
            nrows=r1 - r0,
            ncols=csr.ncols,
            row_ptr=(csr.row_ptr[r0 : r1 + 1] - p0).astype(np.int64),
            col_idx=csr.col_idx[p0:p1],
            values=csr.values[p0:p1],
        )
        sell = SellMatrix.from_csr(sub, **sell_kwargs)
        dev = devices[i % len(devices)]
        shards.append((dev, device_put_sell(sell, dtype, device=dev)))
        row_starts.append(r1)
    return MultiDeviceSell(shards, np.asarray(row_starts), csr.nrows, csr.ncols,
                           csr.nnz, dtype)
