"""Panel-sharded PR SpMV, one rank per shard.

Counterpart of the JAX package's ``parallel/spmd_pr.py``. PR panels are
independent Beneš problems, so the decomposition is panel-parallel: the
panel list is split over a mesh axis, ``pps`` panels a shard, x is whole on
every rank, and every rank runs the port's PR kernel
(:func:`..ops.pr.pr_spmv`) on its panels; one ``all_gather`` hands every
rank every panel's y, and each chunk's rows go back to their natural
places through its ``y_pos``.

The panels are built as the JAX function builds them, so that they share
their geometry (Beneš rows, K ladder, y length): rows in descending-nnz
order are cut into ``n_shards * pps`` chunks of equal entries, each chunk's
natural K ladder is computed, the ladders are unioned (per-K largest group
count), and every chunk is converted with
``PRMatrix.from_csr(force_ladder=union, min_rows=...)``; ``pps`` grows
until the geometry fits ``target_rows``. ``shard_map`` needs that shared
geometry; the y pieces of the gather need it here.

``build_spmd_pr(..., mesh=None)`` keeps every panel on the host
(``panels``); with a mesh, each rank uploads only its own
(:meth:`SpmdPR.upload`, :func:`..ops.pr.device_put_pr`: the routing is
composed at upload).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.pr import MAX_PR_ROWS, PRMatrix, _sub_csr
from ..formats.sell import DEFAULT_K_BINS, GROUP_ROWS, LANES, SUBLANES
from ..ops.pr import device_put_pr, pr_spmv
from ..ops.sell import device_put_x
from .sharding import (_axis, _check_uploaded, _gather_rows, _mesh_device,
                       _shard_of)

__all__ = ["SpmdPR", "build_spmd_pr", "pr_spmv_spmd"]


@dataclass
class SpmdPR:
    # host PRMatrix per chunk, shard-major (None: another rank's)
    panels: list
    chunk_rows: tuple        # natural row ids per chunk (chunk-local order)
    y_pos: tuple             # kernel y position per chunk row
    pps: int                 # panels per shard
    y_len: int               # kernel y length per panel
    nrows: int
    ncols: int
    axis: str
    dtype: torch.dtype = torch.float32
    local: list | None = None   # this rank's DevicePR panels
    # on the device: y[dest] = panel outputs (flat, rank-major)[src]
    dest: torch.Tensor | None = None
    src: torch.Tensor | None = None
    rank: int | None = None

    @property
    def n_shards(self) -> int:
        return len(self.chunk_rows) // self.pps

    def upload(self, mesh) -> "SpmdPR":
        """This rank's ``pps`` panels on its device, and the unpermute
        indices of every chunk; returns a copy holding them."""
        r = _shard_of(mesh, self.axis, self.panels[::self.pps])
        own = range(r * self.pps, (r + 1) * self.pps)
        dev = _mesh_device(mesh)
        local = [device_put_pr(self.panels[c], self.dtype, device=dev)
                 for c in own]
        dest = np.concatenate(self.chunk_rows).astype(np.int64)
        src = np.concatenate([c * self.y_len + np.asarray(p, np.int64)
                              for c, p in enumerate(self.y_pos)])
        return dataclasses.replace(
            self, local=local, dest=torch.from_numpy(dest).to(dev),
            src=torch.from_numpy(src).to(dev), rank=r)


def _chunk_ladders(csr: CSRMatrix, order: np.ndarray, bounds: list,
                   k_bins: tuple):
    """Per-chunk (ladder dict K->groups, s_rows) — the cheap dest/src
    geometry pass of PRMatrix.from_csr, without any routing."""
    edges = np.asarray(sorted({int(k) for k in k_bins}), dtype=np.int64)
    nnz_per_row = np.diff(csr.row_ptr).astype(np.int64)
    R = -(-csr.ncols // LANES)
    out = []
    for lo, hi in bounds:
        rows = order[lo:hi]
        glen = nnz_per_row[rows]
        ladder = {}
        for g0 in range(0, rows.size, GROUP_ROWS):
            gmax = int(glen[g0:g0 + GROUP_ROWS].max())
            bigger = edges[edges >= max(gmax, 1)]
            K = int(bigger[0]) if bigger.size else -(-gmax // 8) * 8
            ladder[K] = ladder.get(K, 0) + 1
        idx = np.concatenate(
            [csr.col_idx[csr.row_ptr[r]:csr.row_ptr[r + 1]] for r in rows]
        ) if rows.size else np.empty(0, np.int64)
        cnt = np.bincount(np.asarray(idx, np.int64) >> 7, minlength=R)
        s_rows = int((-(-cnt[cnt > 0] // LANES)).sum())
        out.append((ladder, s_rows))
    return out


def build_spmd_pr(csr: CSRMatrix, n_shards: int, *, mesh=None,
                  axis: str = "rows", k_bins: tuple = DEFAULT_K_BINS,
                  target_rows: int = 1 << 14, dtype=torch.float32,
                  native: bool = True) -> SpmdPR:
    """Convert ``csr`` (heavy rows pre-split, as for any PR conversion)
    into ``n_shards * pps`` geometry-identical PR panels; raises
    ``ValueError`` when ``target_rows`` is below the union ladder's floor.
    Values are f32 or bf16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"PR values are torch.float32 or torch.bfloat16, "
                         f"not {dtype}")
    if csr.nnz == 0:
        raise ValueError("SPMD PR needs at least one entry")
    nnz_per_row = np.diff(csr.row_ptr).astype(np.int64)
    order = np.argsort(-nnz_per_row, kind="stable").astype(np.int64)
    centry = np.cumsum(nnz_per_row[order])

    pps = 1
    best_rows, stale = None, 0
    while True:
        C = n_shards * pps
        # equal-entry chunk bounds at row granularity (sigma order)
        targets = (np.arange(1, C + 1) * csr.nnz) // C
        cut = np.searchsorted(centry, targets, side="left") + 1
        cut = np.minimum(cut, csr.nrows)
        bounds, lo = [], 0
        for hi in cut:
            hi = max(int(hi), lo + 1) if lo < csr.nrows else lo
            bounds.append((lo, hi))
            lo = hi
        bounds[-1] = (bounds[-1][0], csr.nrows)
        geom = _chunk_ladders(csr, order, bounds, k_bins)
        union = {}
        for ladder, _ in geom:
            for K, c in ladder.items():
                union[K] = max(union.get(K, 0), c)
        d_rows = sum(K * SUBLANES * c for K, c in union.items())
        need = max(d_rows, max(s for _, s in geom), 2)
        n_rows = 1
        while n_rows < need:
            n_rows <<= 1
        if n_rows <= min(target_rows, MAX_PR_ROWS):
            break
        # the union ladder has a floor (one group per K level): stop as
        # soon as growing the panel count stops shrinking the geometry
        if best_rows is not None and n_rows >= best_rows:
            stale += 1
        else:
            best_rows, stale = n_rows, 0
        if stale >= 3 or n_shards * (pps + 1) > 4096:
            raise ValueError(
                f"SPMD PR: target_rows={target_rows} is below this "
                f"matrix's union-ladder floor (~{best_rows or n_rows} "
                "Beneš rows); raise target_rows")
        pps += 1

    force_ladder = tuple(sorted(union.items(), key=lambda t: -t[0]))
    panels, chunk_rows = [], []
    for lo, hi in bounds:
        rows = order[lo:hi]
        sub = _sub_csr(csr, rows)
        panels.append(PRMatrix.from_csr(
            sub, k_bins=k_bins, native=native, force_ladder=force_ladder,
            min_rows=n_rows, max_rows=max(n_rows, MAX_PR_ROWS)))
        chunk_rows.append(rows)

    p0 = panels[0]
    if not all((p.bins, p.n_rows, p.y_rows, p.win)
               == (p0.bins, p0.n_rows, p0.y_rows, p0.win) for p in panels):
        raise RuntimeError("force_ladder harmonization left panels of "
                           "different geometry")
    spmd = SpmdPR(panels=panels, chunk_rows=tuple(chunk_rows),
                  y_pos=tuple(p.y_pos for p in panels), pps=pps,
                  y_len=p0.y_rows * LANES, nrows=csr.nrows, ncols=csr.ncols,
                  axis=axis, dtype=dtype)
    return spmd if mesh is None else spmd.upload(mesh)


def _local_pr(spmd: SpmdPR, x_tab: torch.Tensor) -> torch.Tensor:
    """This rank's panels' full kernel outputs, ``(pps * y_len,)``."""
    return torch.cat([pr_spmv(d, x_tab, crop=False) for d in spmd.local])


def _unpermute(spmd: SpmdPR, y_all: torch.Tensor) -> torch.Tensor:
    """Every chunk's rows back to their natural places."""
    y = torch.zeros(spmd.nrows, dtype=y_all.dtype, device=y_all.device)
    y[spmd.dest] = y_all[spmd.src]
    return y


def pr_spmv_spmd(spmd: SpmdPR, x, mesh) -> torch.Tensor:
    """``y = A @ x`` with every rank running the PR kernel on its panels; x
    (host array) whole on every rank. Returns the global f32 y in natural
    row order on this rank's device."""
    _check_uploaded(spmd.local, "pr_spmv_spmd")
    x_tab = device_put_x(np.asarray(x), spmd.ncols, device=_mesh_device(mesh))
    n, _, group = _axis(mesh, spmd.axis)
    y_all = _gather_rows(_local_pr(spmd, x_tab),
                         [spmd.pps * spmd.y_len] * n, group)
    return _unpermute(spmd, y_all)
