"""Locality-split layout: near-band SELL + natural-order PR for the far tail.

The road-network / circuit regime (reference webbase & roadNet classes,
the reference framework's ``result/result_cuda.csv:11-12``) is ~95% band-local
(|col-row| within one x-slab) with a few-percent scattered tail. Measured
on TPU (docs/DESIGN.md round-3): every masked-pass SELL kernel pays ~one
vector-op pass per (group, distinct slab), and the scattered tail inflates
a 1024-row group's distinct-slab count from ~10 to ~137 — the tail, not
the band, sets the wall time. The Beneš-routing PR kernel is the one
primitive whose cost scales with entries instead of distinct slabs, but
its output is in sigma (k-binned) row order, which would force a device
scatter (~0.1-1 G elem/s on TPU — forbidden) to combine with a SELL y.

The trick here: give PR a derived matrix in which EVERY row has EXACTLY
one entry. ``PRMatrix.from_csr`` orders destination rows by
``argsort(-nnz_per_row, kind="stable")`` — with uniform row nnz that is
the IDENTITY, so the PR kernel's output is already in natural row order
and combines with the SELL y by a single vector add:

    y = sell(near + far-overflow entries) + pr_natural(one far entry/row)

* rows with >= 1 far entry contribute their FIRST far entry to the PR
  part; additional far entries overflow back into the SELL matrix (rare —
  they re-inflate slab lists only marginally and the cost model reprices).
* rows with no far entry get an explicit zero-valued pad entry. Pad
  columns are assigned to fill the far slabs' FREE LANES (each populated
  x-slab's source rows hold a multiple of 128 lane slots), so the pads
  do not grow the Beneš problem: road_like stays at 8192 rows.

Reference parity: this composite answers the thread-per-row CUDA kernel
(cuda_src/csr_matrix_cuda.cu:122-148) on its winning regime (roadNet-PA
31.55 GF, webbase 15.08) with a TPU-native split instead of a
thread-per-row translation.
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/formats/split.py (the port must not
# import the JAX package); tests/test_torch_split.py holds the two
# array-equal. The far side keeps its 2^14-row cap, a TPU VMEM bound, so
# that the host products stay equal; the port's device side has no such cap.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csr import CSRMatrix
from .pr import PanelPRMatrix, PRMatrix, pr_from_csr
from .sell import LANES, SellMatrix

__all__ = ["SplitMatrix", "split_csr", "split_stats"]

# candidate near thresholds, in x-slabs of |col//128 - row//128|
_AUTO_DISTS = (1, 2, 4, 8, 16, 32)
# a split only pays when the tail is small: beyond this the PR part should
# own the whole matrix instead (plain pallas_pr stage)
_MAX_FAR_FRAC = 0.30
# per-panel Beneš row cap for the far side. 2^14 is the dd kernel's VMEM
# capacity (ops/pallas_pr_dd.py DD_PANEL_TARGET_ROWS: four scratch planes),
# and also the f32 size this worker's compile helper accepts reliably —
# building to the smaller cap lets ONE host product serve both precisions
# (the harness reuses the f32 stage's SplitMatrix for pallas_split_dd).
_FAR_TARGET_ROWS = 1 << 14


def split_stats(csr: CSRMatrix, slab_dist: int) -> dict:
    """Host-side profitability stats for a candidate near threshold."""
    rows = csr.row_ids().astype(np.int64)
    dist = np.abs((csr.col_idx.astype(np.int64) >> 7) - (rows >> 7))
    far = dist > slab_dist
    g = rows >> 10
    ng = int(g.max()) + 1 if rows.size else 0
    key_all = g * (1 << 24) + (csr.col_idx.astype(np.int64) >> 7)
    key_near = key_all[~far]
    return {
        "slab_dist": int(slab_dist),
        "far_frac": float(far.mean()) if rows.size else 0.0,
        "gslabs_all": int(np.unique(key_all).size) / max(ng, 1),
        "gslabs_near": int(np.unique(key_near).size) / max(ng, 1),
    }


def split_csr(csr: CSRMatrix, *, slab_dist="auto",
              max_far_frac: float = _MAX_FAR_FRAC):
    """The host split underlying :class:`SplitMatrix` (reused by the SPMD
    builder, parallel/spmd_split.py). Returns
    ``(near_csr, pr_csr, slab_dist, far_frac)`` where ``pr_csr`` has
    EXACTLY one entry per row (each far row's first far entry; zero-value
    pads elsewhere, columns assigned to fill the far slabs' free lanes)."""
    if csr.nnz == 0:
        raise ValueError("split layout needs at least one entry")
    rows = csr.row_ids().astype(np.int64)
    col = csr.col_idx.astype(np.int64)
    dist = np.abs((col >> 7) - (rows >> 7))
    if slab_dist == "auto":
        chosen = None
        for d in _AUTO_DISTS:
            st = split_stats(csr, d)
            if (st["far_frac"] <= max_far_frac
                    and st["gslabs_near"] <= 0.5 * st["gslabs_all"]):
                chosen = d
                break
        if chosen is None:
            raise ValueError(
                "no profitable near threshold: matrix is pure-band "
                "(use SellMatrix) or zero-locality (use PRMatrix)")
        slab_dist = chosen
    slab_dist = int(slab_dist)
    far = dist > slab_dist
    far_frac = float(far.mean())
    if far_frac > max_far_frac:
        raise ValueError(
            f"far fraction {far_frac:.2f} > {max_far_frac} at "
            f"slab_dist={slab_dist} — use plain PRMatrix instead")

    # FIRST far entry of each row -> PR; the rest overflow to SELL
    far_idx = np.flatnonzero(far)
    far_rows = rows[far_idx]
    first_mask = np.ones(far_idx.size, dtype=bool)
    first_mask[1:] = far_rows[1:] != far_rows[:-1]  # CSR row-sorted
    pr_idx = far_idx[first_mask]

    keep = np.ones(csr.nnz, dtype=bool)
    keep[pr_idx] = False
    near_counts = np.bincount(rows[keep], minlength=csr.nrows)
    near_ptr = np.zeros(csr.nrows + 1, dtype=np.int64)
    np.cumsum(near_counts, out=near_ptr[1:])
    near_csr = CSRMatrix(csr.nrows, csr.ncols, near_ptr,
                         csr.col_idx[keep], csr.values[keep])

    # ---- far part: one entry per row, natural-order PR ----
    pr_col = np.zeros(csr.nrows, dtype=np.int64)
    pr_val = np.zeros(csr.nrows, dtype=csr.values.dtype)
    pr_rows_real = rows[pr_idx]
    pr_col[pr_rows_real] = col[pr_idx]
    pr_val[pr_rows_real] = csr.values[pr_idx]
    # pad rows: fill the far slabs' free lanes so source rows don't grow;
    # spill into the densest far slab (extra rows there are the fallback,
    # still one slab)
    pad_rows = np.flatnonzero(np.bincount(
        pr_rows_real, minlength=csr.nrows) == 0)
    if pad_rows.size:
        far_slabs = col[pr_idx] >> 7
        if far_slabs.size:
            uniq, cnt = np.unique(far_slabs, return_counts=True)
            free = (-(-cnt // LANES)) * LANES - cnt
            fill_slabs = np.repeat(uniq, free)
            if fill_slabs.size < pad_rows.size:
                fill_slabs = np.concatenate([
                    fill_slabs,
                    np.full(pad_rows.size - fill_slabs.size,
                            int(uniq[np.argmax(cnt)]), dtype=np.int64),
                ])
            pad_cols = fill_slabs[: pad_rows.size] * LANES
        else:  # degenerate: no far entries at all
            pad_cols = np.zeros(pad_rows.size, dtype=np.int64)
        pr_col[pad_rows] = np.minimum(pad_cols, csr.ncols - 1)
    ones = np.ones(csr.nrows, dtype=np.int64)
    pr_ptr = np.zeros(csr.nrows + 1, dtype=np.int64)
    np.cumsum(ones, out=pr_ptr[1:])
    pr_csr = CSRMatrix(csr.nrows, csr.ncols, pr_ptr,
                       pr_col.astype(np.int32), pr_val)
    return near_csr, pr_csr, slab_dist, far_frac


@dataclass(frozen=True)
class SplitMatrix:
    """Host conversion product; upload with
    :func:`..ops.split.device_put_split`."""

    nrows: int
    ncols: int
    nnz: int
    slab_dist: int
    far_frac: float
    near: SellMatrix   # near entries + far overflow (>=2nd far entry/row)
    far: object        # PRMatrix | PanelPRMatrix: uniform k=1, natural order
                       # (row panels for matrices beyond one Beneš problem's
                       # cap; uniform k keeps panel concat in natural order)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def memory_stats(self) -> dict:
        ns = self.near.memory_stats()
        fs = self.far.memory_stats()
        # near streams ja+as (4+4 B per padded slot at f32); far streams the
        # four PR planes (counted by PRMatrix.memory_stats)
        near_bytes = int(ns["padded_nnz"]) * 8
        total = near_bytes + fs["bytes"]
        return {
            "bytes": total,
            "near": ns,
            "far": fs,
            "slab_dist": self.slab_dist,
            "far_frac": self.far_frac,
            "padding_ratio": total / max(self.nnz * 8, 1),
        }

    # ------------------------------------------------------------------
    @classmethod
    def from_csr(cls, csr: CSRMatrix, *, slab_dist="auto",
                 max_far_frac: float = _MAX_FAR_FRAC,
                 far_target_rows: int = _FAR_TARGET_ROWS,
                 **sell_kw) -> "SplitMatrix":
        """Split ``csr`` by column-slab distance from the diagonal.

        ``slab_dist="auto"`` picks the smallest threshold in
        ``_AUTO_DISTS`` whose far fraction is <= ``max_far_frac`` AND that
        removes at least half the per-group distinct slabs; raises
        ``ValueError`` when no threshold qualifies (the matrix is either
        pure-band — use plain SELL — or zero-locality — use plain PR).
        ``far_target_rows`` caps one far Beneš problem; larger matrices get
        contiguous row-slice panels (PanelPRMatrix) whose concatenated
        output is STILL natural row order because every far row holds
        exactly one entry (stable sigma sort = identity within and across
        panels). ``sell_kw`` forwards to ``SellMatrix.from_csr`` for the
        near part.
        """
        near_csr, pr_csr, slab_dist, far_frac = split_csr(
            csr, slab_dist=slab_dist, max_far_frac=max_far_frac)
        near = SellMatrix.from_csr(near_csr, **sell_kw)
        far_pr = pr_from_csr(pr_csr, k_bins=(1,),
                             target_rows=far_target_rows)
        # uniform nnz -> stable argsort is the identity: the PR kernel's
        # output is ALREADY natural row order, the whole point of the pads.
        # Panel builds must preserve it too (contiguous chunks, identity
        # sigma inside each panel, no skipped chunks: every row has an
        # entry, so no all-zero sigma tail exists).
        assert far_pr.row_perm.size == 0 or (
            far_pr.row_perm == np.arange(csr.nrows)).all()

        return cls(nrows=csr.nrows, ncols=csr.ncols, nnz=csr.nnz,
                   slab_dist=slab_dist, far_frac=far_frac,
                   near=near, far=far_pr)

    # ------------------------------------------------------------------
    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host fp64 oracle twin of the device composite."""
        return self.near.spmv(x) + self.far.spmv(x)
