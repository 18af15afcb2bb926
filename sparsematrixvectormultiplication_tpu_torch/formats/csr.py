"""CSR format — host conversion + device-resident arrays.

TPU-first re-design of the reference CSR converter
(reference src/csr_matrix.c:63-126: count -> prefix-sum -> scatter -> per-row
quicksort by column). Here the whole conversion is one vectorized
``np.lexsort`` over (row, col), which both builds CSR order and sorts each
row's columns in a single O(nnz log nnz) pass — no per-row Python loops, so
100M-nnz matrices convert in seconds (SURVEY §7 hard part 4).
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/formats/csr.py (the port must not
# import the JAX package); tests/test_torch_formats.py holds the two
# array-equal. One change: the native converter (native=True, or nnz >=
# _NATIVE_MIN_NNZ) runs this package's native/fast_csr.cpp and raises when it
# cannot be built, where the JAX loader fell back to numpy.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .coo import COOMatrix

__all__ = ["CSRMatrix"]


@dataclass(frozen=True)
class CSRMatrix:
    """≙ reference ``CSRMatrix{M,N,nz,row_ptr,col_idx,values}`` (libs/csr_matrix.h:8-16)."""

    nrows: int
    ncols: int
    row_ptr: np.ndarray  # (nrows+1,) int64
    col_idx: np.ndarray  # (nnz,) int32
    values: np.ndarray   # (nnz,) float

    @property
    def nnz(self) -> int:
        return int(self.col_idx.size)

    @property
    def shape(self) -> tuple:
        return (self.nrows, self.ncols)

    # nnz above which the native counting-sort converter beats np.lexsort
    _NATIVE_MIN_NNZ = 2_000_000

    @classmethod
    def from_coo(cls, coo: COOMatrix, *, sort_columns: bool = True,
                 native: bool | None = None) -> "CSRMatrix":
        """Build CSR (≙ reference convert_in_csr, csr_matrix.c:63).

        Large matrices route through the native C++ counting-sort converter
        (native/fast_csr.cpp, O(nnz) vs lexsort's O(nnz log nnz)); small ones
        and non-f64 values use the vectorized numpy path. ``native`` forces
        the choice; the native path raises when it cannot be built."""
        use_native = (
            sort_columns
            and coo.nnz >= cls._NATIVE_MIN_NNZ
            and coo.val.dtype == np.float64
            and coo.ncols < 2**31
            if native is None
            else native
        )
        if use_native:
            from ..native.build import coo_to_csr_native

            row_ptr, col_idx, values = coo_to_csr_native(
                coo.row, coo.col, coo.val, coo.nrows)
            return cls(coo.nrows, coo.ncols, row_ptr, col_idx, values)
        if sort_columns:
            order = np.lexsort((coo.col, coo.row))
        else:
            order = np.argsort(coo.row, kind="stable")
        col_idx = np.ascontiguousarray(coo.col[order], dtype=np.int32)
        values = np.ascontiguousarray(coo.val[order])
        counts = np.bincount(coo.row, minlength=coo.nrows)
        row_ptr = np.zeros(coo.nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return cls(coo.nrows, coo.ncols, row_ptr, col_idx, values)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def row_ids(self) -> np.ndarray:
        """Expanded per-entry row index (for segment-sum SpMV)."""
        return np.repeat(
            np.arange(self.nrows, dtype=np.int32), self.row_nnz().astype(np.int64)
        )

    def memory_stats(self) -> dict:
        """CSR footprint report (≙ reference write_memory_stats_to_csv,
        src/csr_matrix.c:28-61)."""
        bytes_row_ptr = self.row_ptr.nbytes
        bytes_col_idx = self.col_idx.nbytes
        bytes_values = self.values.nbytes
        return {
            "rows": self.nrows,
            "cols": self.ncols,
            "nnz": self.nnz,
            "bytes_row_ptr": bytes_row_ptr,
            "bytes_col_idx": bytes_col_idx,
            "bytes_values": bytes_values,
            "bytes_total": bytes_row_ptr + bytes_col_idx + bytes_values,
            "bytes_per_nnz": (bytes_row_ptr + bytes_col_idx + bytes_values)
            / max(self.nnz, 1),
        }

    def to_coo(self) -> COOMatrix:
        return COOMatrix(self.nrows, self.ncols, self.row_ids(), self.col_idx, self.values)

    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        """Adopt any ``scipy.sparse`` matrix (sorted-column CSR)."""
        c = m.tocsr()
        c.sort_indices()
        return cls(int(c.shape[0]), int(c.shape[1]),
                   c.indptr.astype(np.int64), c.indices.astype(np.int32),
                   np.asarray(c.data, np.float64))

    def to_scipy(self):
        """View as ``scipy.sparse.csr_matrix`` (zero-copy arrays)."""
        import scipy.sparse as sp

        return sp.csr_matrix((self.values, self.col_idx, self.row_ptr),
                             shape=(self.nrows, self.ncols))

    def transpose(self) -> "CSRMatrix":
        """``A^T`` as a new CSR (counting-sort over swapped coordinates).

        Gives every kernel layout an ``A^T @ x`` path for free — needed by
        transpose-Krylov methods and PageRank-style column-stochastic
        operators. The reference has no transpose anywhere; its pipeline
        would re-parse a transposed ``.mtx``."""
        coo = self.to_coo()
        return CSRMatrix.from_coo(
            COOMatrix(self.ncols, self.nrows, coo.col, coo.row, coo.val))

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def split_heavy_rows(self, cap: int = 1024, strided: bool = False):
        """Split rows with more than ``cap`` entries into ``ceil(nnz/cap)``
        segment rows, returning ``(csr_ext, seg_map)`` where ``seg_map[i]``
        is the original row of extended row ``i`` — reduce with
        ``segment_sum(y_ext, seg_map)``.

        ``strided=False`` (zero-copy: only ``row_ptr`` changes): segment
        ``j`` takes the row's entries ``[j*cap, (j+1)*cap)`` — consecutive
        COLUMN runs, right for column-range-sensitive layouts (sb-major).

        ``strided=True`` (reorders the heavy rows' entries): segment ``j``
        takes entries ``j, j+nseg, j+2*nseg, ...`` — each segment a uniform
        column-thinned copy of the row, so no segment concentrates in one
        column region. Required by the SG shared-window layout, where a
        locally-dense segment cascades through tile layers (formats/sg.py);
        each segment's entries remain column-sorted (stride subsequence of
        a sorted run).

        The textbook fix for power-law heads: ultra-heavy rows (webbase-1M
        class) otherwise force SELL bins whose (K*8, 128) tiles exceed VMEM.
        Returns ``(self, None)`` when no row exceeds ``cap``.
        """
        counts = self.row_nnz().astype(np.int64)
        if self.nrows == 0 or (counts.max(initial=0) <= cap):
            return self, None
        nseg = np.maximum(-(-counts // cap), 1)
        seg_map = np.repeat(np.arange(self.nrows, dtype=np.int32), nseg)
        seg_off = np.zeros(self.nrows + 1, dtype=np.int64)
        np.cumsum(nseg, out=seg_off[1:])
        m_ext = int(seg_off[-1])
        seg_idx = np.arange(m_ext, dtype=np.int64) - seg_off[:-1][seg_map]
        if not strided:
            ext_start = self.row_ptr[:-1][seg_map] + seg_idx * cap
            new_ptr = np.append(ext_start, np.int64(self.nnz))
            return (
                CSRMatrix(m_ext, self.ncols, new_ptr, self.col_idx,
                          self.values),
                seg_map,
            )
        # strided: permute each heavy row's entries so segment j's entries
        # sit consecutively: entry k of original row r (k-th by column) goes
        # to segment k % nseg[r] at within-segment position k // nseg[r]
        row_of = np.repeat(np.arange(self.nrows, dtype=np.int64),
                           counts)
        k = np.arange(self.nnz, dtype=np.int64) - self.row_ptr[:-1][row_of]
        ns = nseg[row_of]
        seg = k % ns
        pos = k // ns
        # segment lengths: ceil((count - seg) / nseg)
        ext_row = seg_off[:-1][row_of] + seg
        seg_len = np.bincount(ext_row, minlength=m_ext).astype(np.int64)
        new_ptr = np.zeros(m_ext + 1, dtype=np.int64)
        np.cumsum(seg_len, out=new_ptr[1:])
        dest = new_ptr[:-1][ext_row] + pos
        col2 = np.empty_like(self.col_idx)
        val2 = np.empty_like(self.values)
        col2[dest] = self.col_idx
        val2[dest] = self.values
        return (
            CSRMatrix(m_ext, self.ncols, new_ptr, col2, val2),
            seg_map,
        )

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Golden serial CSR SpMV in fp64 on host (the framework oracle).

        ≙ reference csr_matrix_vector_mult (src/csr_matrix.c:130-139), but
        vectorized: products then ``np.add.reduceat`` over row starts.
        """
        x = np.asarray(x)
        prod = self.values.astype(np.float64) * x.astype(np.float64)[self.col_idx]
        y = np.zeros(self.nrows, dtype=np.float64)
        nz_rows = self.row_ptr[:-1] != self.row_ptr[1:]
        if prod.size:
            starts = self.row_ptr[:-1][nz_rows]
            y[nz_rows] = np.add.reduceat(prod, starts)
        return y
