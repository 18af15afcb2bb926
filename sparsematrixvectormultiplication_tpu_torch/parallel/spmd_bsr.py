"""Row-sharded block-sparse SpMM, one rank per shard.

Counterpart of the JAX package's ``parallel/spmd_bsr.py``: block-rows are
split into ``n_shards`` uniform contiguous slices, the dense RHS block X is
whole on every rank, and every rank runs the port's BSR kernel
(:func:`..ops.bsr.bsr_spmm`) on its slice; one ``all_gather`` hands every
rank the whole Y. BSR's block slots per block-row (``kb``) are global, so
the shards need no harmonizing: only the block-row count pads to the shard
multiple, with all-zero blocks.

``shard_bsr(..., mesh=None)`` keeps every shard on the host (``shards[i]``:
a ``BSRMatrix`` of ``local_rows`` rows whose arrays equal the JAX
``stacked`` arrays ``[i]``); with a mesh, each rank uploads only its own
(:meth:`SpmdBSR.upload`, :func:`..ops.bsr.device_put_bsr`, tile masks and
all).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.bsr import BLOCK, BSRMatrix
from ..ops.bsr import DeviceBSR, bsr_spmm, device_put_bsr, pad_rhs
from .sharding import (_axis, _check_uploaded, _gather_rows, _mesh_device,
                       _shard_of)

__all__ = ["SpmdBSR", "shard_bsr", "bsr_spmm_spmd"]


@dataclass
class SpmdBSR:
    shards: list            # host BSRMatrix per shard (None: another rank's)
    shard_rows: np.ndarray  # real (unpadded) rows owned per shard
    local_rows: int         # padded rows per shard
    nrows: int
    ncols: int
    axis: str
    dtype: torch.dtype = torch.float32
    local: DeviceBSR | None = None
    rank: int | None = None

    @property
    def n_shards(self) -> int:
        return int(self.shard_rows.size)

    def upload(self, mesh) -> "SpmdBSR":
        """This rank's shard on its device; returns a copy holding it as
        ``local``."""
        r = _shard_of(mesh, self.axis, self.shards)
        return dataclasses.replace(
            self, local=device_put_bsr(self.shards[r], self.dtype,
                                       device=_mesh_device(mesh)), rank=r)


def shard_bsr(bsr: BSRMatrix, n_shards: int, *, mesh=None,
              axis: str = "rows", dtype=torch.float32) -> SpmdBSR:
    """Split block-rows into ``n_shards`` uniform contiguous slices."""
    kb = bsr.kb
    br_local = max(-(-bsr.n_block_rows // n_shards), 1)
    br_pad = br_local * n_shards

    blocks = np.zeros((br_pad * kb, BLOCK, BLOCK), bsr.blocks.dtype)
    blocks[:bsr.n_block_rows * kb] = bsr.blocks
    bcols = np.zeros(br_pad * kb, np.int32)
    bcols[:bsr.n_block_rows * kb] = bsr.block_cols

    blocks = blocks.reshape(n_shards, br_local * kb, BLOCK, BLOCK)
    bcols = bcols.reshape(n_shards, br_local * kb)
    shard_rows = np.clip(bsr.nrows - np.arange(n_shards) * br_local * BLOCK,
                         0, br_local * BLOCK)
    per = br_local * kb
    shards = [BSRMatrix(
        nrows=br_local * BLOCK, ncols=bsr.ncols,
        nnz=int(np.count_nonzero(blocks[i])), kb=kb, n_block_rows=br_local,
        blocks=blocks[i], block_cols=bcols[i],
        n_real_blocks=int(np.count_nonzero(
            blocks[i].reshape(per, -1).any(axis=1))))
        for i in range(n_shards)]
    spmd = SpmdBSR(shards=shards, shard_rows=shard_rows.astype(np.int64),
                   local_rows=br_local * BLOCK, nrows=bsr.nrows,
                   ncols=bsr.ncols, axis=axis, dtype=dtype)
    return spmd if mesh is None else spmd.upload(mesh)


def bsr_spmm_spmd(spmd: SpmdBSR, X, mesh) -> torch.Tensor:
    """``Y = A @ X`` with every rank running the BSR kernel on its block-rows.

    ``X`` is ``(ncols, B)`` (host array, whole on every rank); it is padded
    to the kernel's layout in the blocks' type (:func:`..ops.bsr.pad_rhs`).
    Returns the global ``(nrows, B)`` f32 Y in natural row order on this
    rank's device."""
    _check_uploaded(spmd.local, "bsr_spmm_spmd")
    X = np.asarray(X)
    b = X.shape[1] if X.ndim == 2 else 1
    xp = pad_rhs(X, spmd.ncols, spmd.local.blocks.dtype,
                 device=_mesh_device(mesh))
    _, _, group = _axis(mesh, spmd.axis)
    Y = bsr_spmm(spmd.local, xp)[:, :b]
    return _gather_rows(Y, spmd.shard_rows, group)
