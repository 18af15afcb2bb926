"""Multi-device SpMV over ``torch.distributed`` device meshes: the ELL
paths (row, column and 2-D sharding) and the mesh plumbing the other
modules of this package share.

Counterpart of the JAX package's ``parallel/sharding.py``. A JAX ``Mesh``
with axis names ``("rows",)``, ``("cols",)`` or ``("rows", "cols")``
becomes a :class:`~torch.distributed.device_mesh.DeviceMesh` with the same
names (:func:`make_mesh`), one process per rank (``parallel/launch.py``):

* **Row sharding (the DP analogue)** — A's rows are split over the mesh's
  ``rows`` axis; every rank holds its rows and the whole x and computes
  its rows of y; one ``all_gather`` hands every rank the whole y.
* **Column sharding (the TP analogue)** — A's columns and x are split;
  every rank computes a partial y over its column slice and an
  ``all_reduce`` over the ``cols`` axis sums the partials (JAX's
  ``psum``).
* **2-D sharding** — both at once on a ``(rows, cols)`` mesh.

The JAX paths here are XLA programs (a gather and a row sum); so are these:
:func:`..ops.xla.ell_spmv` on each rank's rectangle, in f64 for f64 values.
Each rank builds the host rectangle and uploads only its own block. Every
function returns the whole y on the rank's device in natural row order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.xla import _acc_dtype, ell_spmv

__all__ = [
    "make_mesh",
    "ShardedELL",
    "shard_ell_rows",
    "row_sharded_spmv",
    "shard_ell_2d",
    "sharded_spmv_2d",
    "col_sharded_spmv",
]


def make_mesh(n_devices: int | None = None, axis_names=("rows",), shape=None,
              *, device_type: str = "cuda") -> DeviceMesh:
    """A device mesh over the ranks of the process group (started by
    ``torchrun``, :func:`.launch.spawn` or the caller); defaults to every
    rank on one ``rows`` axis. ``device_type="cpu"`` asks for CPU ranks."""
    n = n_devices or dist.get_world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(f"a mesh over {axis_names} needs its shape")
        shape = (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current GPU, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh: DeviceMesh, name: str) -> tuple:
    """``(size, this rank's index, process group)`` of mesh axis ``name``;
    ``(1, 0, None)`` when the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 1, 0, None
    return (int(mesh.shape[names.index(name)]), mesh.get_local_rank(name),
            mesh.get_group(name))


def _shard_of(mesh: DeviceMesh, axis: str, shards: list) -> int:
    """This rank's index on mesh axis ``axis``, which must hold one rank
    per shard; its host shard must be there (not dropped for another
    rank)."""
    n, r, _ = _axis(mesh, axis)
    if n != len(shards):
        raise ValueError(f"{len(shards)} shards on a mesh axis {axis!r} of "
                         f"{n} ranks")
    if shards[r] is None:
        raise ValueError(f"shard {r} is not in this host build (built for "
                         "another rank)")
    return r


def _check_uploaded(local, fn: str):
    if local is None:
        raise ValueError(f"{fn} runs an uploaded shard: build with a mesh "
                         "or call .upload(mesh) first")


def _gather_rows(y_loc: torch.Tensor, shard_rows, group) -> torch.Tensor:
    """Every rank's equally long ``y_loc`` (rows first), each cropped to its
    ``shard_rows`` entry and concatenated in rank order: the whole y."""
    y_loc = y_loc.contiguous()
    if group is None:
        return y_loc[: int(shard_rows[0])]
    parts = [torch.empty_like(y_loc) for _ in shard_rows]
    dist.all_gather(parts, y_loc, group=group)
    return torch.cat([p[: int(r)] for p, r in zip(parts, shard_rows)])


def _sum_over(y: torch.Tensor, group) -> torch.Tensor:
    """``psum``: the sum of every rank's ``y`` on each rank."""
    if group is not None:
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _x_on(x, device, dtype) -> torch.Tensor:
    """x (host array or tensor) on ``device`` in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.asarray(x)).to(dtype).to(device)


class ShardedELL:
    """This rank's rows of a row-sharded padded-ELL rectangle, and the
    padding bookkeeping."""

    def __init__(self, ja, as_, nrows, ncols, nnz, rows_padded, axis="rows"):
        self.ja = ja
        self.as_ = as_
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)
        self.rows_padded = int(rows_padded)
        self.axis = axis


def _pad_rows(ja, as_, rows_padded):
    extra = rows_padded - ja.shape[0]
    if extra > 0:
        ja = np.concatenate([ja, np.zeros((extra, ja.shape[1]), ja.dtype)])
        as_ = np.concatenate([as_, np.zeros((extra, as_.shape[1]), as_.dtype)])
    return ja, as_


def _values(as_: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(as_))
    return t if dtype is None else t.to(dtype)


def shard_ell_rows(hll, mesh: DeviceMesh, *, dtype=None,
                   axis: str = "rows") -> ShardedELL:
    """Upload this rank's rows of an HLL matrix's ELL rectangle.

    Rows are padded to a multiple of the mesh axis size, as the JAX
    function pads them (equal row counts per shard; the nnz balance is
    :func:`.scheduler.balanced_partition`'s). ``dtype`` (a torch dtype)
    casts the values; the default keeps the host's."""
    ja, as_ = hll.to_rect()
    n_shards, r, _ = _axis(mesh, axis)
    rows_padded = -(-ja.shape[0] // n_shards) * n_shards
    ja, as_ = _pad_rows(ja, as_, rows_padded)
    per = rows_padded // n_shards
    dev = _mesh_device(mesh)
    return ShardedELL(
        torch.from_numpy(np.ascontiguousarray(ja[r * per:(r + 1) * per]))
        .to(dev),
        _values(as_[r * per:(r + 1) * per], dtype).to(dev),
        hll.nrows, hll.ncols, hll.nnz, rows_padded, axis)


def _local_rows_ell(sharded: ShardedELL, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of y, x (whole) on its device."""
    acc = _acc_dtype(sharded.as_.dtype)
    return ell_spmv(sharded.ja, sharded.as_.to(acc), x.to(acc))


def _collect_rows_ell(sharded: ShardedELL, y: torch.Tensor,
                      mesh: DeviceMesh) -> torch.Tensor:
    n_shards, _, group = _axis(mesh, sharded.axis)
    per = sharded.rows_padded // n_shards
    return _gather_rows(y, [per] * n_shards, group)[: sharded.nrows]


def row_sharded_spmv(sharded: ShardedELL, x, mesh: DeviceMesh, *,
                     axis: str = "rows") -> torch.Tensor:
    """y = A @ x with A row-sharded and x whole on every rank: each rank's
    rows, then one ``all_gather`` over ``axis``."""
    if axis != sharded.axis:
        raise ValueError(f"the ELL was sharded over {sharded.axis!r}, "
                         f"not {axis!r}")
    x = _x_on(x, sharded.as_.device, _acc_dtype(sharded.as_.dtype))
    return _collect_rows_ell(sharded, _local_rows_ell(sharded, x), mesh)


class Sharded2D:
    """This rank's block of a (rows, cols)-sharded ELL: its row shard's
    entries that fall in its column shard, at slice-local columns."""

    def __init__(self, ja, as_, col_starts, nrows, ncols, nnz, rows_padded,
                 cols_padded):
        self.ja = ja
        self.as_ = as_
        self.col_starts = col_starts
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)
        self.rows_padded = int(rows_padded)
        self.cols_padded = int(cols_padded)


def _relayout_2d(hll, nr_sh: int, nc_sh: int, dtype=None) -> tuple:
    """The host re-layout of :func:`shard_ell_2d` (the JAX function's, as
    it is): ``(ja2, as2, rows_padded, cols_padded)``, ``ja2``/``as2`` of
    shape ``(rows_padded, nc_sh, K2)``. Every stored nonzero goes to the
    column shard that owns its column, at a slice-local column; the
    sub-rectangles are padded to a common K2 with column 0, value 0. A
    stored zero is dropped (it adds nothing: the port's stored-zero rule).
    ``dtype`` is a numpy dtype for the values, or None."""
    ja, as_ = hll.to_rect()
    if dtype is not None:
        as_ = as_.astype(dtype)
    M = ja.shape[0]
    rows_padded = -(-M // nr_sh) * nr_sh
    ja, as_ = _pad_rows(ja, as_, rows_padded)
    cols_padded = -(-hll.ncols // nc_sh) * nc_sh
    cols_per = cols_padded // nc_sh

    shard_of_entry = np.minimum(ja // cols_per, nc_sh - 1)
    # per (row, col-shard) counts -> common K2
    counts = np.zeros((rows_padded, nc_sh), dtype=np.int64)
    valid = as_ != 0
    np.add.at(counts, (np.repeat(np.arange(rows_padded), ja.shape[1]),
                       shard_of_entry.reshape(-1)), valid.reshape(-1))
    K2 = max(1, int(counts.max()))

    ja2 = np.zeros((rows_padded, nc_sh, K2), dtype=np.int32)
    as2 = np.zeros((rows_padded, nc_sh, K2), dtype=as_.dtype)
    # stable fill: iterate entries in row-major order, vectorized by cumcount
    r_idx = np.repeat(np.arange(rows_padded), ja.shape[1])[valid.reshape(-1)]
    s_idx = shard_of_entry.reshape(-1)[valid.reshape(-1)]
    flat_rs = r_idx * nc_sh + s_idx
    order = np.argsort(flat_rs, kind="stable")
    sorted_rs = flat_rs[order]
    first = np.ones(sorted_rs.size, dtype=bool)
    first[1:] = sorted_rs[1:] != sorted_rs[:-1]
    slot_sorted = np.arange(sorted_rs.size) - np.maximum.accumulate(
        np.where(first, np.arange(sorted_rs.size), 0)
    )
    slot = np.empty_like(slot_sorted)
    slot[order] = slot_sorted
    local_col = (ja.reshape(-1)[valid.reshape(-1)] - s_idx * cols_per).astype(np.int32)
    ja2[r_idx, s_idx, slot] = local_col
    as2[r_idx, s_idx, slot] = as_.reshape(-1)[valid.reshape(-1)]
    return ja2, as2, rows_padded, cols_padded


def shard_ell_2d(hll, mesh: DeviceMesh, *, dtype=None) -> Sharded2D:
    """Upload this rank's block of a (rows, cols)-sharded ELL
    (:func:`_relayout_2d`). A mesh without a ``rows`` axis is one row
    shard; one without ``cols``, one column shard."""
    nr_sh, r, _ = _axis(mesh, "rows")
    nc_sh, c, _ = _axis(mesh, "cols")
    ja2, as2, rows_padded, cols_padded = _relayout_2d(hll, nr_sh, nc_sh)
    per = rows_padded // nr_sh
    dev = _mesh_device(mesh)
    return Sharded2D(
        torch.from_numpy(np.ascontiguousarray(ja2[r * per:(r + 1) * per, c]))
        .to(dev),
        _values(as2[r * per:(r + 1) * per, c], dtype).to(dev),
        None, hll.nrows, hll.ncols, hll.nnz, rows_padded, cols_padded)


def _x_slice_2d(sharded: Sharded2D, x, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's column slice of x, zero-padded, on its device."""
    nc_sh, c, _ = _axis(mesh, "cols")
    cols_per = sharded.cols_padded // nc_sh
    acc = _acc_dtype(sharded.as_.dtype)
    x = _x_on(x, sharded.as_.device, acc)
    xp = torch.zeros(sharded.cols_padded, dtype=acc, device=x.device)
    xp[: x.shape[0]] = x
    return xp[c * cols_per:(c + 1) * cols_per]


def _local_2d(sharded: Sharded2D, xloc: torch.Tensor) -> torch.Tensor:
    """This rank's partial product over its column slice."""
    acc = _acc_dtype(sharded.as_.dtype)
    return ell_spmv(sharded.ja, sharded.as_.to(acc), xloc)


def _collect_2d(sharded: Sharded2D, partial: torch.Tensor,
                mesh: DeviceMesh) -> torch.Tensor:
    nr_sh, _, rows_group = _axis(mesh, "rows")
    _, _, cols_group = _axis(mesh, "cols")
    y = _sum_over(partial, cols_group)
    per = sharded.rows_padded // nr_sh
    return _gather_rows(y, [per] * nr_sh, rows_group)[: sharded.nrows]


def sharded_spmv_2d(sharded: Sharded2D, x, mesh: DeviceMesh) -> torch.Tensor:
    """y = A @ x on a (rows, cols) mesh: each rank's partial product over
    its column slice of x, an ``all_reduce`` over ``cols`` (JAX's
    ``psum``), then an ``all_gather`` of the row shards over ``rows``."""
    partial = _local_2d(sharded, _x_slice_2d(sharded, x, mesh))
    return _collect_2d(sharded, partial, mesh)


def col_sharded_spmv(hll, x, mesh: DeviceMesh, *, dtype=None) -> torch.Tensor:
    """Pure column sharding on a 1-axis mesh named ``cols``: x sharded,
    partial y summed by ``all_reduce``. The 2-D path with one row shard."""
    return sharded_spmv_2d(shard_ell_2d(hll, mesh, dtype=dtype), x, mesh)
