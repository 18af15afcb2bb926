"""Row-sharded locality-split SpMV, one rank per shard.

Counterpart of the JAX package's ``parallel/spmd_split.py``. Each rank owns
a contiguous group-aligned row range and runs both halves of the composite
on it: the near SELL bins (:func:`.spmd_pallas.build_spmd_sell`'s shards)
and a natural-order PR far side over the SAME partition; x is whole on
every rank, the two halves join by one same-shape add, and one
``all_gather`` hands every rank the whole y.

The far side has exactly one entry per row (``formats/split.py:split_csr``),
so every shard's K ladder is the single run ``(1, ng_max)`` and only the
Beneš row count needs a shared power of two (``min_rows``, the largest any
shard needs). Its kernel y is then as long as the near side's ``local_rows``.
Every shard must hold rows; ``build_spmd_split`` refuses otherwise, as the
JAX function does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.pr import MAX_PR_ROWS, PRMatrix
from ..formats.sell import GROUP_ROWS, LANES, SUBLANES
from ..formats.split import split_csr
from ..ops.pr import DevicePR, device_put_pr, pr_spmv
from ..ops.sell import device_put_x, sell_spmv
from .sharding import (_axis, _check_uploaded, _gather_rows, _mesh_device,
                       _shard_of)
from .spmd_pallas import SpmdSell, build_spmd_sell

__all__ = ["SpmdSplit", "build_spmd_split", "split_spmv_spmd"]


@dataclass
class SpmdSplit:
    near: SpmdSell         # row shards of the near SELL
    far: list              # host PRMatrix per shard (None: another rank's)
    nrows: int
    ncols: int
    nnz: int
    axis: str
    dtype: torch.dtype = torch.float32
    far_local: DevicePR | None = None
    rank: int | None = None

    def upload(self, mesh) -> "SpmdSplit":
        """This rank's near shard and far panel on its device; returns a
        copy holding them."""
        near = self.near.upload(mesh)
        r = _shard_of(mesh, self.axis, self.far)
        return dataclasses.replace(
            self, near=near, far_local=device_put_pr(
                self.far[r], self.dtype, device=_mesh_device(mesh)), rank=r)


def build_spmd_split(csr: CSRMatrix, n_shards: int, *, dtype=torch.float32,
                     mesh=None, axis: str = "rows", slab_dist="auto",
                     sell_kwargs: dict | None = None) -> SpmdSplit:
    near_csr, pr_csr, _d, _ff = split_csr(csr, slab_dist=slab_dist)
    near = build_spmd_sell(near_csr, n_shards, dtype=dtype, axis=axis,
                           sell_kwargs=sell_kwargs)
    gb = near.group_bounds
    if (gb[:, 0] == gb[:, 1]).any():
        raise ValueError(
            f"split SPMD needs every shard non-empty: {n_shards} shards "
            f"over {-(-csr.nrows // GROUP_ROWS)} groups")
    ng_max = near.local_rows // GROUP_ROWS

    # shared Beneš row count: per shard, source rows = sum ceil(slab
    # count / 128) over its columns; dest rows = the FORCED ladder's
    # ng_max groups x 8
    need = ng_max * SUBLANES
    col = pr_csr.col_idx.astype(np.int64)
    for gs, ge in gb:
        r0, r1 = int(gs) * GROUP_ROWS, min(int(ge) * GROUP_ROWS, csr.nrows)
        cnt = np.bincount(col[r0:r1] >> 7)
        need = max(need, int((-(-cnt[cnt > 0] // LANES)).sum()))
    n_rows = 1
    while n_rows < max(need, 2):
        n_rows <<= 1

    panels = []
    for gs, ge in gb:
        r0, r1 = int(gs) * GROUP_ROWS, min(int(ge) * GROUP_ROWS, csr.nrows)
        sub = CSRMatrix(r1 - r0, csr.ncols,
                        np.arange(r1 - r0 + 1, dtype=np.int64),
                        pr_csr.col_idx[r0:r1], pr_csr.values[r0:r1])
        p = PRMatrix.from_csr(sub, k_bins=(1,),
                              force_ladder=((1, ng_max),), min_rows=n_rows,
                              max_rows=max(n_rows, MAX_PR_ROWS))
        # single-K forced ladder + uniform one-entry rows: kernel y is the
        # natural row order prefix (the composite's whole premise)
        if p.y_pos is not None and not (p.y_pos == np.arange(r1 - r0)).all():
            raise RuntimeError("the far panel's kernel y is not in natural "
                               "row order")
        panels.append(p)

    p0 = panels[0]
    if not all((p.bins, p.n_rows, p.y_rows, p.win)
               == (p0.bins, p0.n_rows, p0.y_rows, p0.win) for p in panels) \
            or p0.y_rows * LANES != near.local_rows:
        raise RuntimeError("the far panels do not share one geometry whose "
                           "y is the near side's local rows")
    spmd = SpmdSplit(near=near, far=panels, nrows=csr.nrows, ncols=csr.ncols,
                     nnz=csr.nnz, axis=axis, dtype=dtype)
    return spmd if mesh is None else spmd.upload(mesh)


def _local_split(spmd: SpmdSplit, x_tab: torch.Tensor) -> torch.Tensor:
    """This rank's ``local_rows`` rows of y: near + far, one add."""
    return (sell_spmv(spmd.near.local, x_tab)
            + pr_spmv(spmd.far_local, x_tab, crop=False))


def split_spmv_spmd(spmd: SpmdSplit, x, mesh) -> torch.Tensor:
    """``y = A @ x`` with the locality-split composite on every rank's
    rows; x (host array) whole on every rank. Returns the global f32 y in
    natural row order on this rank's device."""
    _check_uploaded(spmd.far_local, "split_spmv_spmd")
    x_tab = device_put_x(np.asarray(x), spmd.ncols, device=_mesh_device(mesh))
    _, _, group = _axis(mesh, spmd.axis)
    return _gather_rows(_local_split(spmd, x_tab), spmd.near.shard_rows,
                        group)
