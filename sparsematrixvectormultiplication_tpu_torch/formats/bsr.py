"""BSR — 128x128 block-sparse layout for multi-vector SpMM.

SpMM (``Y = A @ X`` with a dense block of ``B`` right-hand sides — multi-RHS
solvers, graph aggregations) feeds every loaded matrix byte into ``B``
multiply-adds. This module stores A as dense (128,128) blocks over the
non-empty 128x128 grid cells, so the kernel (ops/bsr.py, csrc/bsr.cu) is a
chain of dense block products with no per-entry gathers.

Trade-off: storage inflates by 1/fill (a block is kept dense). That is the
right trade for the clustered/banded regimes; it is the wrong trade for
zero-locality scattered matrices, where nearly every entry lands in its own
block — ``from_csr`` enforces a byte budget and reports fill statistics so
callers can route those matrices to the gather-based kernels instead.

Layout: ELL-over-blocks. Block-row g (rows ``128g .. 128g+127``) owns ``kb``
block slots (``kb`` = max non-empty blocks of any block-row); slot ``(g, j)``
stores a dense (128,128) value tile and its block-column id. Pad slots hold
an all-zero tile pointing at block-column 0 — they contribute nothing.
"""

# Numpy host layer copied from
# sparsematrixvectormultiplication_tpu/formats/bsr.py (the port must not
# import the JAX package); tests/test_torch_bsr.py holds the two array-equal.
# One change: the native blocker (native=True, or nnz >= _NATIVE_MIN_NNZ)
# runs this package's native/fast_bsr.cpp and raises when it cannot be built
# or fails, where the original falls back to numpy without a word.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csr import CSRMatrix

__all__ = ["BSRMatrix", "BLOCK"]

BLOCK = 128  # block edge: rows and columns of one dense tile


@dataclass
class BSRMatrix:
    """Host-side 128x128 block-sparse matrix (ELL over blocks)."""

    nrows: int
    ncols: int
    nnz: int
    kb: int                  # block slots per block-row (incl. padding)
    n_block_rows: int
    blocks: np.ndarray       # (n_block_rows * kb, 128, 128) value dtype
    block_cols: np.ndarray   # (n_block_rows * kb,) int32, pads -> 0
    n_real_blocks: int

    @property
    def n_block_cols(self) -> int:
        return -(-self.ncols // BLOCK)

    @property
    def fill(self) -> float:
        """nnz / stored-block area over the REAL (non-pad) blocks."""
        return self.nnz / max(self.n_real_blocks * BLOCK * BLOCK, 1)

    @property
    def pad_ratio(self) -> float:
        """Stored block slots per real block (ELL padding factor)."""
        return self.n_block_rows * self.kb / max(self.n_real_blocks, 1)

    @property
    def nbytes(self) -> int:
        return self.blocks.nbytes + self.block_cols.nbytes

    # nnz above which the native O(nnz) stamp-dedup blocker replaces the
    # numpy np.unique path (seconds per 10M entries)
    _NATIVE_MIN_NNZ = 1_000_000

    @classmethod
    def from_csr(cls, csr: CSRMatrix, *, value_dtype=np.float32,
                 max_bytes: int = 2 << 30,
                 native: bool | None = None) -> "BSRMatrix":
        """Block a CSR matrix onto the 128x128 grid.

        Raises ``ValueError`` naming the budget when the dense-block
        expansion would exceed ``max_bytes`` — the signal that the matrix
        belongs to the gather-based layouts (formats/sell.py,
        formats/sg.py), not to the dense-block path. Large matrices route
        through the native blocker (native/fast_bsr.cpp, O(nnz) stamp-array
        dedup per block-row), which raises when it cannot be built;
        ``native`` forces the choice.
        """
        nnz = csr.nnz
        n_br = max(-(-csr.nrows // BLOCK), 1)
        n_bc = max(-(-csr.ncols // BLOCK), 1)
        if nnz == 0:
            blocks = np.zeros((n_br, BLOCK, BLOCK), value_dtype)
            bcols = np.zeros(n_br, np.int32)
            return cls(csr.nrows, csr.ncols, 0, 1, n_br, blocks, bcols, 0)

        use_native = (
            nnz >= cls._NATIVE_MIN_NNZ
            and np.dtype(value_dtype) in (np.float32, np.float64)
            if native is None else native
        )
        if use_native:
            from ..native.build import csr_to_bsr_native

            blocks, bcols, kb, n_real = csr_to_bsr_native(
                csr.row_ptr, csr.col_idx, csr.values, csr.nrows, n_bc,
                value_dtype, max_bytes)
            return cls(csr.nrows, csr.ncols, nnz, kb, n_br, blocks, bcols,
                       n_real)

        rows = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                         np.diff(csr.row_ptr))
        cols = csr.col_idx.astype(np.int64)
        brow = rows >> 7
        key = brow * n_bc + (cols >> 7)
        uniq, inv = np.unique(key, return_inverse=True)
        u_brow = (uniq // n_bc).astype(np.int64)
        u_bcol = (uniq % n_bc).astype(np.int32)

        per_br = np.bincount(u_brow, minlength=n_br)
        kb = int(per_br.max())
        stored = n_br * kb * BLOCK * BLOCK * np.dtype(value_dtype).itemsize
        if stored > max_bytes:
            raise ValueError(_budget_message(stored, uniq.size, kb, nnz,
                                             max_bytes))

        # slot of each unique block within its block-row (uniq is sorted,
        # so blocks of one block-row are consecutive)
        first = np.searchsorted(u_brow, np.arange(n_br))
        slot_in_row = np.arange(uniq.size) - first[u_brow]
        slot = (u_brow * kb + slot_in_row).astype(np.int64)

        blocks = np.zeros((n_br * kb, BLOCK, BLOCK), value_dtype)
        bcols = np.zeros(n_br * kb, np.int32)
        bcols[slot] = u_bcol
        # CSR rows are column-sorted (formats/csr.py), so duplicate
        # (row, col) entries — legal in .mtx coordinate files, and summed
        # by the oracle/spmv semantics — are ADJACENT. Direct assignment
        # (fast path) would keep only the last one; detect and np.add.at
        # (summing, but ~10x slower) only when duplicates actually exist.
        dup = np.any((rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])) \
            if nnz > 1 else False
        tgt = (slot[inv], rows & (BLOCK - 1), cols & (BLOCK - 1))
        if dup:
            np.add.at(blocks, tgt, csr.values.astype(value_dtype))
        else:
            blocks[tgt] = csr.values.astype(value_dtype)
        return cls(csr.nrows, csr.ncols, nnz, kb, n_br, blocks, bcols,
                   int(uniq.size))

    def spmm(self, X: np.ndarray) -> np.ndarray:
        """fp64 host oracle over the BLOCKED data: validates the blocking
        itself against the CSR oracle (tests compare both to scipy)."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            return self.spmm(X[:, None])[:, 0]
        n_bc = self.n_block_cols
        Xp = np.zeros((n_bc * BLOCK, X.shape[1]), np.float64)
        Xp[:X.shape[0]] = X
        Y = np.zeros((self.n_block_rows * BLOCK, X.shape[1]), np.float64)
        for g in range(self.n_block_rows):
            acc = np.zeros((BLOCK, X.shape[1]), np.float64)
            for j in range(self.kb):
                s = g * self.kb + j
                bc = int(self.block_cols[s])
                acc += self.blocks[s].astype(np.float64) @ \
                    Xp[bc * BLOCK:(bc + 1) * BLOCK]
            Y[g * BLOCK:(g + 1) * BLOCK] = acc
        return Y[:self.nrows]


def _budget_message(stored: int, n_blocks: int, kb: int, nnz: int,
                    max_bytes: int) -> str:
    """The budget refusal of both blockers."""
    return (f"BSR expansion is {stored / 2**20:.0f} MiB "
            f"({n_blocks} blocks, kb={kb}, fill "
            f"{nnz / max(n_blocks * BLOCK * BLOCK, 1):.4f}) > "
            f"{max_bytes / 2**20:.0f} MiB budget — this matrix is too "
            "scattered for the dense-block path; use the SELL/SG "
            "layouts instead")
