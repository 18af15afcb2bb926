"""Column-sharded SELL SpMV, one rank per shard: the TP-style path.

Counterpart of the JAX package's ``parallel/spmd_colsell.py``.
``spmd_pallas.py`` shards rows and keeps x whole on every rank. Here the
COLUMNS are sharded: each rank holds a SELL conversion of its column slice
of A (all rows) and only its slice of x, computes a full-length partial y
with the port's kernels (:func:`..ops.sell.sell_spmv`), and one
``all_reduce`` over the ``cols`` axis sums the partials (JAX's ``psum``).

Byte model (docs/DESIGN.md "Column vs row sharding"): per rank and call,
row sharding streams A/n + x and writes y/n; column sharding streams A/n +
x/n and reduces a FULL y. Column sharding wins only where x dominates.

Column slices are different matrices, so each is converted on its own,
forced to k-major over a shared K ladder, with a uniform ``cols_per``
(slab-aligned) and x table (``r_loc`` rows). The JAX function pads every
shard's bins to the union of K keys with trash groups for ``shard_map``'s
one program; a rank runs its own, so each shard here is uploaded at its
natural size, and its bins, in ascending K, equal the real part of the JAX
``stacked`` arrays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.sell import (DEFAULT_K_BINS, LANES, SellMatrix,
                            slab_table_rows)
from ..ops.sell import DeviceSell, device_put_sell, pack_x_table, sell_spmv
from .sharding import (_axis, _check_uploaded, _mesh_device, _shard_of,
                       _sum_over)

__all__ = ["SpmdColSell", "build_spmd_sell_cols", "sell_spmv_spmd_cols"]


@dataclass
class SpmdColSell:
    # host SellMatrix per column slice (None: another rank's)
    shards: list
    cols_per: int            # uniform columns per shard (slab-aligned)
    r_loc: int               # local packed-x table rows
    nrows: int
    ncols: int
    nnz: int
    axis: str = "cols"
    dtype: torch.dtype = torch.float32
    local: DeviceSell | None = None
    rank: int | None = None

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def upload(self, mesh) -> "SpmdColSell":
        """This rank's column slice on its device; returns a copy holding
        it as ``local``."""
        r = _shard_of(mesh, self.axis, self.shards)
        return dataclasses.replace(
            self, local=device_put_sell(self.shards[r], self.dtype,
                                        device=_mesh_device(mesh)), rank=r)


def _slice_cols(csr: CSRMatrix, c_lo: int, c_hi: int) -> CSRMatrix:
    """All rows, columns in [c_lo, c_hi), column ids made slice-local.
    CSR column order within rows is preserved (slices keep sortedness)."""
    keep = (csr.col_idx >= c_lo) & (csr.col_idx < c_hi)
    # per-row counts of kept entries -> new row_ptr
    row_of = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                       np.diff(csr.row_ptr).astype(np.int64))
    kept_rows = row_of[keep]
    counts = np.bincount(kept_rows, minlength=csr.nrows)
    ptr = np.zeros(csr.nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return CSRMatrix(csr.nrows, c_hi - c_lo, ptr,
                     (csr.col_idx[keep] - c_lo).astype(csr.col_idx.dtype),
                     csr.values[keep])


def build_spmd_sell_cols(
    csr: CSRMatrix,
    n_shards: int,
    *,
    dtype=torch.float32,
    mesh=None,
    axis: str = "cols",
    k_bins=DEFAULT_K_BINS,
) -> SpmdColSell:
    """Convert each of ``n_shards`` uniform column slices of ``csr`` to a
    k-major SELL. ``mesh=None`` keeps every shard on the host; with a mesh,
    this rank's shard is uploaded (:meth:`SpmdColSell.upload`)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value dtype {dtype} not supported "
                         "(torch.float32 or torch.bfloat16)")
    n_shards = max(1, n_shards)
    cols_per = -(-max(csr.ncols, 1) // (n_shards * LANES)) * LANES
    shards = []
    for i in range(n_shards):
        # uniform cols_per on every shard (the tail range may reach past
        # ncols — _slice_cols keeps only real entries; the uniform local
        # width is what pack_x_cols needs)
        sell = SellMatrix.from_csr(
            _slice_cols(csr, i * cols_per, (i + 1) * cols_per),
            k_bins=k_bins, layout="k-major")
        shards.append(dataclasses.replace(
            sell, bins=sorted(sell.bins, key=lambda b: int(b.k))))
    spmd = SpmdColSell(shards=shards, cols_per=cols_per,
                       r_loc=slab_table_rows(cols_per), nrows=csr.nrows,
                       ncols=csr.ncols, nnz=csr.nnz, axis=axis, dtype=dtype)
    return spmd if mesh is None else spmd.upload(mesh)


def pack_x_cols(spmd: SpmdColSell, x, mesh) -> torch.Tensor:
    """This rank's slice of x as its padded f32 x table (``r_loc * 128``
    entries) on its device."""
    _, r, _ = _axis(mesh, spmd.axis)
    xp = np.zeros(spmd.n_shards * spmd.cols_per, np.float32)
    xp[: spmd.ncols] = np.asarray(x)[: spmd.ncols]
    xs = torch.from_numpy(xp[r * spmd.cols_per:(r + 1) * spmd.cols_per])
    return pack_x_table(xs, spmd.cols_per).to(_mesh_device(mesh))


def _local_cols(spmd: SpmdColSell, x_tab: torch.Tensor) -> torch.Tensor:
    """This rank's full-length partial y over its column slice."""
    return sell_spmv(spmd.local, x_tab)


def sell_spmv_spmd_cols(spmd: SpmdColSell, x, mesh) -> torch.Tensor:
    """y = A @ x with columns sharded and one ``all_reduce`` over the
    ``cols`` axis; returns the global f32 y on this rank's device."""
    _check_uploaded(spmd.local, "sell_spmv_spmd_cols")
    _, _, group = _axis(mesh, spmd.axis)
    return _sum_over(_local_cols(spmd, pack_x_cols(spmd, x, mesh)), group)
