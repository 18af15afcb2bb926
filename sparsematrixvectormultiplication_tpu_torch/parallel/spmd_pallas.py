"""Row-sharded SELL SpMV and SpMM, one rank per shard.

Counterpart of the JAX package's ``parallel/spmd_pallas.py``, which runs the
SELL kernels under ``shard_map``. Here each rank of a device mesh
(``parallel/sharding.py:make_mesh``) holds one shard and runs the port's
kernels on it (:func:`..ops.sell.sell_spmv`, :func:`..ops.sell_spmm.sell_spmm`);
x is whole on every rank, and one ``all_gather`` hands every rank the whole
y.

The shards are the JAX function's: rows split into ``n_shards`` contiguous,
group-aligned, nnz-balanced ranges (``balanced_partition``), and ONE global
SELL conversion sliced by shard (:func:`_spmd_from_sell`): each bin's
ascending group list splits at the shard bounds, its planes and tables
split with it, and its group ids are re-based to the shard's first group.
``shard_map`` needs one program, so the JAX function pads every shard's bin
to the largest with groups that write a trash tile; a rank runs its own
program, so a shard here is uploaded at its natural size. Its real part
equals the JAX ``stacked`` arrays ``[i, :n_real]``. Each rank's y is
``local_rows`` long (the largest shard's groups), as JAX pads it, so the
gathered pieces are equal; ``shard_rows`` crops them.

``build_spmd_sell(..., mesh=None)`` keeps every shard on the host; with a
mesh, each rank uploads only its own (:meth:`SpmdSell.upload`) with the
port's :func:`..ops.sell.device_put_sell`, so every upload-time step of the
single-device path (wl, sb-list and sg compaction, k-major x windows)
applies to each shard. Values are f32 or bf16, the kernels' types.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.sell import GROUP_ROWS, SUBLANES, SellMatrix
from ..ops.sell import DeviceSell, device_put_sell, device_put_x, sell_spmv
from ..ops.sell_spmm import device_put_x_multi, sell_spmm
from .scheduler import balanced_partition
from .sharding import (_axis, _check_uploaded, _gather_rows, _mesh_device,
                       _shard_of)

__all__ = ["SpmdSell", "build_spmd_sell", "sell_spmv_spmd",
           "sell_spmm_spmd"]

_VALUE_TYPES = (torch.float32, torch.bfloat16)


@dataclass
class SpmdSell:
    """Row shards of one SELL conversion (``shards[i]``: a host
    ``SellMatrix`` of shard i's rows, group ids from 0, or None in a build
    handed to another rank) and, once uploaded on a mesh, this rank's shard
    on its device (``local``)."""

    shards: list
    shard_rows: np.ndarray   # (n_shards,) real rows per shard
    local_rows: int          # y rows per shard (ng_max * 1024)
    nrows: int
    ncols: int
    nnz: int
    axis: str = "rows"
    # (n_shards, 2) [group_start, group_end) of each shard's row range:
    # composites (spmd_split.py) build aligned shards of a sibling
    # structure over the SAME partition
    group_bounds: np.ndarray | None = None
    dtype: torch.dtype = torch.float32
    local: DeviceSell | None = None
    rank: int | None = None

    @property
    def n_shards(self) -> int:
        return int(self.shard_rows.size)

    def upload(self, mesh) -> "SpmdSell":
        """This rank's shard (its index on the mesh axis) on its device;
        returns a copy holding it as ``local``."""
        r = _shard_of(mesh, self.axis, self.shards)
        d = device_put_sell(self.shards[r], self.dtype,
                            device=_mesh_device(mesh))
        # y as long as the largest shard's: equal pieces to gather
        d = dataclasses.replace(d, nrows=self.local_rows,
                                num_groups=self.local_rows // GROUP_ROWS)
        return dataclasses.replace(self, local=d, rank=r)


def _partition(csr: CSRMatrix, n_shards: int) -> tuple:
    """``(group_starts, group_ends, shard_rows)``: ``n_shards`` contiguous
    nnz-balanced group ranges, empty ranges last when the groups run out."""
    num_groups = -(-csr.nrows // GROUP_ROWS) if csr.nrows else 0
    row_nnz = np.zeros(num_groups * GROUP_ROWS, dtype=np.int64)
    row_nnz[: csr.nrows] = csr.row_nnz()
    group_nnz = row_nnz.reshape(num_groups, GROUP_ROWS).sum(axis=1)
    part = list(balanced_partition(group_nnz, min(n_shards, max(num_groups, 1))))
    # every rank gets a shard: pad with empty ranges
    while len(part) < n_shards:
        part.append((num_groups, num_groups, 0))
    gstarts = np.array([gs for gs, _, _ in part], np.int64)
    gends = np.array([ge for _, ge, _ in part], np.int64)
    shard_rows = np.array([
        max(0, min(ge * GROUP_ROWS, csr.nrows) - min(gs * GROUP_ROWS, csr.nrows))
        for gs, ge in zip(gstarts, gends)], np.int64)
    return gstarts, gends, shard_rows


def _check_dtype(dtype):
    if dtype not in _VALUE_TYPES:
        raise ValueError(f"value dtype {dtype} not supported "
                         "(torch.float32 or torch.bfloat16)")


def _spmd_from_sell(sell: SellMatrix, csr: CSRMatrix, n_shards: int, *,
                    dtype=torch.float32, axis: str = "rows") -> SpmdSell:
    """Slice ``sell`` (converted from ``csr`` in natural row order) into
    ``n_shards`` row shards over ``csr``'s nnz-balanced group ranges."""
    _check_dtype(dtype)
    if (sell.nrows, sell.ncols) != (csr.nrows, csr.ncols):
        raise ValueError(f"a {sell.nrows} x {sell.ncols} SELL of a "
                         f"{csr.nrows} x {csr.ncols} CSR")
    if getattr(sell, "row_perm", None) is not None:
        raise ValueError("sigma_sort permutes rows across shard boundaries; "
                         "sort before sharding instead")
    n_shards = max(1, n_shards)
    gstarts, gends, shard_rows = _partition(csr, n_shards)
    ng_max = max(int((gends - gstarts).max()), 1)

    per_shard = [[] for _ in range(n_shards)]
    for b in sell.bins:
        gids = np.asarray(b.group_ids, np.int64)
        kb = int(b.k) * SUBLANES
        sl = np.asarray(b.slab_list, np.int32)
        if sl.ndim == 1:
            sl = sl.reshape(max(b.n_groups, 1), -1) if b.n_groups else \
                sl.reshape(0, 1)
        # shard boundaries within this bin's ascending group list
        lo = np.searchsorted(gids, gstarts)
        hi = np.searchsorted(gids, gends)
        for i in range(n_shards):
            a, z = int(lo[i]), int(hi[i])
            if z == a:
                continue
            per_shard[i].append(dataclasses.replace(
                b, group_ids=(gids[a:z] - gstarts[i]).astype(np.int32),
                ja=b.ja[a * kb:z * kb], as_=b.as_[a * kb:z * kb],
                slab_list=sl[a:z],
                slab_count=np.asarray(b.slab_count[a:z], np.int32),
                real_nnz=int(np.count_nonzero(b.as_[a * kb:z * kb]))))
    ptr = csr.row_ptr[np.minimum(np.stack([gstarts, gends]) * GROUP_ROWS,
                                 csr.nrows)]
    shards = [dataclasses.replace(
        sell, nrows=int(shard_rows[i]), nnz=int(ptr[1, i] - ptr[0, i]),
        bins=bins, num_groups=int(gends[i] - gstarts[i]))
        for i, bins in enumerate(per_shard)]
    return SpmdSell(shards=shards, shard_rows=shard_rows,
                    local_rows=ng_max * GROUP_ROWS, nrows=csr.nrows,
                    ncols=csr.ncols, nnz=csr.nnz, axis=axis,
                    group_bounds=np.stack([gstarts, gends], axis=1),
                    dtype=dtype)


def build_spmd_sell(
    csr: CSRMatrix,
    n_shards: int,
    *,
    dtype=torch.float32,
    mesh=None,
    axis: str = "rows",
    sell_kwargs: dict | None = None,
) -> SpmdSell:
    """Row-shard ``csr`` into ``n_shards`` group-aligned nnz-balanced ranges
    of ONE global SELL conversion (``SellMatrix.from_csr(csr,
    **sell_kwargs)``). ``mesh=None`` keeps every shard on the host; with a
    mesh, this rank's shard is uploaded (:meth:`SpmdSell.upload`).
    ``sigma_sort`` raises ``ValueError``."""
    sell_kwargs = dict(sell_kwargs or {})
    if sell_kwargs.get("sigma_sort"):
        raise ValueError("sigma_sort permutes rows across shard boundaries; "
                         "sort before sharding instead")
    _check_dtype(dtype)
    spmd = _spmd_from_sell(SellMatrix.from_csr(csr, **sell_kwargs), csr,
                           n_shards, dtype=dtype, axis=axis)
    return spmd if mesh is None else spmd.upload(mesh)


def _local_spmv(spmd: SpmdSell, x_tab: torch.Tensor) -> torch.Tensor:
    """This rank's ``local_rows`` rows of y (x table on its device)."""
    return sell_spmv(spmd.local, x_tab)


def sell_spmv_spmd(spmd: SpmdSell, x, mesh) -> torch.Tensor:
    """y = A @ x with every rank running the SELL kernels on its shard; x
    (host array) whole on every rank. Returns the global f32 y in natural
    row order on this rank's device (one ``all_gather`` over the axis)."""
    _check_uploaded(spmd.local, "sell_spmv_spmd")
    x_tab = device_put_x(np.asarray(x), spmd.ncols, device=_mesh_device(mesh))
    _, _, group = _axis(mesh, spmd.axis)
    return _gather_rows(_local_spmv(spmd, x_tab), spmd.shard_rows, group)


def sell_spmm_spmd(spmd: SpmdSell, X, mesh) -> torch.Tensor:
    """Y = A @ X (R <= 32 right-hand sides, :func:`..ops.sell_spmm.sell_spmm`)
    with rows sharded and the x table whole on every rank; the shards'
    bins must be k-major or wl (build with ``sell_kwargs={"layout":
    "k-major"}`` where the conversion would pick others). Returns the
    global ``(nrows, R)`` f32 Y in natural row order on this rank's
    device."""
    _check_uploaded(spmd.local, "sell_spmm_spmd")
    xt = device_put_x_multi(np.asarray(X), spmd.ncols,
                            device=_mesh_device(mesh))
    _, _, group = _axis(mesh, spmd.axis)
    return _gather_rows(sell_spmm(spmd.local, xt), spmd.shard_rows, group)
