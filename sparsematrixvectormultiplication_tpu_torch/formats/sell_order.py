"""The row order of the port's SELL conversion: heavy-tailed rows become
SELL-C-sigma, with y still in the caller's row order.

:class:`SellMatrix` is the class the package exports. Its
:meth:`SellMatrix.from_csr` is :meth:`.sell.SellMatrix.from_csr` (the copy
held array-equal to the JAX package's) with one rule in front of it. Each
1024-row group of the default binning is padded to its longest row, so on
a matrix whose row lengths are heavy-tailed (a power-law graph with its
labels permuted puts a hub in nearly every group) the groups store many
times the entries: 207 slots an entry on GAP's kron graph at SCALE 20. The
rule (:func:`heavy_tailed`) is a function of the row lengths alone: where
the default binning would store more than :data:`HEAVY_SLOTS` slots an
entry (the bound past which the package's harness, ``bench/harness.py``,
rebuilds a SELL sorted) and sorting the rows by length (SELL-C-sigma) would
at least halve that, the conversion sorts them.

Sorted, a hub's row is still one row, and the kernels give a row to one
thread: on kron at SCALE 20 the row of 64k entries took 10 ms a product on
an H100, against some 40 us for the whole matrix's bytes. So the sorted
conversion first splits every row of more than :data:`HEAVY_ROW_CAP`
entries into segments of at most that many (``split_heavy_rows``, strided
as the sg layout wants them), and keeps its row map
(:attr:`SellMatrix.row_map`): for each caller row, the sorted positions of
its segments. ``device_put_sell`` gives the container the map, and
``sell_spmv`` returns y in the caller's row order, each row the sum of its
segments in order, the rows with no entry 0. Every other matrix converts as
the copy converts it, and so does every call that names ``sigma_sort`` or a
``layout`` itself: an explicit ``sigma_sort=True`` keeps its y in sorted
order, unsplit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..utils.profiling import setup_span
from . import sell as _sell
from .csr import CSRMatrix

__all__ = ["SellMatrix", "binned_slots", "heavy_tailed", "row_map",
           "HEAVY_SLOTS", "SIGMA_GAIN", "HEAVY_ROW_CAP"]

# more stored slots an entry than this under the default binning make a
# matrix's rows heavy-tailed (fem3d-class 1.2-1.3, bands and road networks
# 1.1-2.5, a copurchase graph 7.5; power-law graphs 65-200)
HEAVY_SLOTS = 8
# and sorting the rows must cut the slots at least this many times
SIGMA_GAIN = 2
# the longest row a sorted conversion keeps whole: a thread adds 256 slots
# in 32 batches of 8, some 30 us of latency on an H100, within the time the
# whole of kron's planes take to stream
HEAVY_ROW_CAP = 256


def binned_slots(row_nnz: np.ndarray, k_bins=_sell.DEFAULT_K_BINS) -> int:
    """The slots the default binning stores for rows of these lengths, in
    this order: each group of 1024 rows padded to the smallest bin edge at
    or above its longest row (edges doubled past the last, as
    :meth:`.sell.SellMatrix.from_csr` extends them; an empty group takes
    one slot a row)."""
    rows = _sell.GROUP_ROWS
    n = int(row_nnz.size)
    if n == 0:
        return 0
    groups = -(-n // rows)
    lens = np.zeros(groups * rows, np.int64)
    lens[:n] = row_nnz
    kg = np.maximum(lens.reshape(groups, rows).max(axis=1), 1)
    edges = np.asarray(sorted({int(e) for e in k_bins}), np.int64)
    top = int(edges[-1])
    over = kg > top
    width = edges[np.minimum(np.searchsorted(edges, kg), edges.size - 1)]
    if over.any():
        doublings = np.ceil(np.log2(kg[over] / top)).astype(np.int64)
        width[over] = top << doublings
    return int(width.sum()) * rows


def heavy_tailed(row_nnz: np.ndarray, k_bins=_sell.DEFAULT_K_BINS) -> bool:
    """Whether rows of these lengths convert as SELL-C-sigma: the default
    binning stores more than :data:`HEAVY_SLOTS` slots an entry, and the
    rows sorted by length at most ``1 / SIGMA_GAIN`` of them."""
    nnz = int(row_nnz.sum())
    if nnz == 0:
        return False
    slots = binned_slots(row_nnz, k_bins)
    if slots <= HEAVY_SLOTS * nnz:
        return False
    return SIGMA_GAIN * binned_slots(-np.sort(-row_nnz), k_bins) <= slots


def row_map(seg_map: np.ndarray, row_perm: np.ndarray,
            seg_nnz: np.ndarray, nrows: int) -> tuple:
    """``(ptr, pos)``, int32: caller row r's segments sit at sorted
    positions ``pos[ptr[r]:ptr[r+1]]``, in the order of its entries; a row
    with no entry has none. ``seg_map`` gives each segment row's caller row
    (non-decreasing), ``row_perm`` each sorted position's segment row,
    ``seg_nnz`` each segment row's entries."""
    where = np.empty(row_perm.size, np.int32)
    where[row_perm] = np.arange(row_perm.size, dtype=np.int32)
    kept = np.flatnonzero(seg_nnz > 0)
    ptr = np.zeros(nrows + 1, np.int32)
    np.cumsum(np.bincount(seg_map[kept], minlength=nrows), out=ptr[1:])
    return ptr, where[kept]


@dataclass(frozen=True)
class SellMatrix(_sell.SellMatrix):
    """:class:`.sell.SellMatrix` converted by the port's row-order rule.

    ``row_map`` is None, or, where the rule split and sorted the rows,
    ``(ptr, pos)`` of :func:`row_map`: ``nrows`` and ``row_perm`` are then
    the segment rows', and :attr:`shape`, :meth:`spmv` and
    :meth:`unpermute` the caller's."""

    row_map: tuple | None = None

    @property
    def shape(self) -> tuple:
        if self.row_map is None:
            return super().shape
        return (self.row_map[0].size - 1, self.ncols)

    def unpermute(self, y: np.ndarray) -> np.ndarray:
        """Sorted-order y back to the caller's rows: with a row map, each
        row the sum of its segments (0 for a row with none)."""
        if self.row_map is None:
            return super().unpermute(y)
        ptr, pos = self.row_map
        owner = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
        return np.bincount(owner, weights=np.asarray(y)[pos],
                           minlength=ptr.size - 1)

    def spmv(self, x: np.ndarray) -> np.ndarray:
        y = super().spmv(x)
        return y if self.row_map is None else self.unpermute(y)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, *, sigma_sort: bool | None = None,
                 **kw) -> "SellMatrix":
        """:meth:`.sell.SellMatrix.from_csr` with ``sigma_sort`` chosen by
        :func:`heavy_tailed` when neither it nor a ``layout`` other than
        "auto" is given; where the rule holds, rows of more than
        :data:`HEAVY_ROW_CAP` entries are split first. The rule's time, with
        the split, is the span ``formats.sell.row_order``, inside
        ``formats.sell.from_csr``."""
        with setup_span("formats.sell.from_csr"):
            if sigma_sort is not None or kw.get("layout", "auto") != "auto":
                return super().from_csr(csr, sigma_sort=bool(sigma_sort),
                                        **kw)
            with setup_span("formats.sell.row_order"):
                if not heavy_tailed(csr.row_nnz(),
                                    kw.get("k_bins", _sell.DEFAULT_K_BINS)):
                    segs = None
                else:
                    segs, seg_map = csr.split_heavy_rows(HEAVY_ROW_CAP,
                                                         strided=True)
                    if seg_map is None:
                        seg_map = np.arange(csr.nrows, dtype=np.int32)
            if segs is None:
                return super().from_csr(csr, **kw)
            sell = super().from_csr(segs, sigma_sort=True, **kw)
            return dataclasses.replace(sell, row_map=row_map(
                seg_map, sell.row_perm, segs.row_nnz(), csr.nrows))
