"""HLL (hacked ELLPACK) format — reference-parity layout, flat-packed.

Re-designs the reference's HLL converter (src/hll_matrix.c:37-257): instead
of a Python/C list of per-block ``ELLPACKBlock`` structs with malloc'd 2-D
arrays (hll_matrix.h:15-27), blocks are packed into flat rectangular numpy
buffers plus an offset table — device code wants rectangular buffers.

Reference semantics preserved exactly:
  - rows grouped in blocks of ``hack_size`` (=32, hll_matrix.h:12)
  - per-block MAXNZ = max row nnz within the block (hll_matrix.c:86-92)
  - entries of each row sorted by column index (hll_matrix.c:204-213)
  - row-major in-block layout ``idx = local_row * MAXNZ + j`` (hll_matrix.c:235)
  - padding: JA = the row's last valid column (0 for empty rows),
    AS = 0.0 (hll_matrix.c:241-246) so padded gathers stay in-bounds and
    contribute nothing
"""

# Numpy host layer copied from sparsematrixvectormultiplication_tpu/formats/hll.py
# (the port must not import the JAX package); tests/test_torch_hll.py holds
# the two array-equal.

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .coo import COOMatrix
from .csr import CSRMatrix

__all__ = ["HLLMatrix", "DEFAULT_HACK_SIZE"]

DEFAULT_HACK_SIZE = 32  # reference hll_matrix.h:12


@dataclass(frozen=True)
class HLLMatrix:
    """≙ reference ``HLLMatrix{num_blocks, blocks[]}`` (libs/hll_matrix.h:15-27),
    flat-packed: block ``b`` occupies ``offsets[b]:offsets[b+1]`` of ``ja``/``as_``
    in row-major (rows_in_block, maxnz[b]) order."""

    nrows: int
    ncols: int
    nnz: int
    hack_size: int
    maxnz: np.ndarray      # (num_blocks,) int32 — per-block MAXNZ
    offsets: np.ndarray    # (num_blocks+1,) int64 — flat offsets
    ja: np.ndarray         # (padded_total,) int32 — column indices (padded)
    as_: np.ndarray        # (padded_total,) float — values (0.0 padding)

    @property
    def num_blocks(self) -> int:
        return int(self.maxnz.size)

    @property
    def shape(self) -> tuple:
        return (self.nrows, self.ncols)

    @property
    def padded_nnz(self) -> int:
        return int(self.ja.size)

    def block_rows(self, b: int) -> int:
        return min(self.hack_size, self.nrows - b * self.hack_size)

    def block(self, b: int) -> tuple:
        """(JA, AS) 2-D views of block ``b`` with shape (rows, maxnz[b])."""
        rows = self.block_rows(b)
        k = int(self.maxnz[b])
        sl = slice(int(self.offsets[b]), int(self.offsets[b]) + rows * k)
        return self.ja[sl].reshape(rows, k), self.as_[sl].reshape(rows, k)

    @classmethod
    def from_csr(cls, csr: CSRMatrix, hack_size: int = DEFAULT_HACK_SIZE) -> "HLLMatrix":
        """Vectorized COO/CSR -> HLL (≙ reference convert_to_hll, hll_matrix.c:37).

        The reference sorts each row by column with qsort; CSR built by
        :meth:`CSRMatrix.from_coo` already has column-sorted rows, so the fill
        is a single vectorized scatter.
        """
        M, hack = csr.nrows, int(hack_size)
        if hack <= 0:
            raise ValueError("hack_size must be positive")
        num_blocks = -(-M // hack) if M else 0
        row_nnz = csr.row_nnz().astype(np.int64)

        # per-block MAXNZ (reference hll_matrix.c:86-92); empty block -> 0 rows
        # still get maxnz >= 1 in the reference (calloc'd arrays exist); we use
        # max(1, ...) so every row has at least one (padded) slot.
        padded_rows = num_blocks * hack
        rn = np.zeros(padded_rows, dtype=np.int64)
        rn[:M] = row_nnz
        maxnz = rn.reshape(num_blocks, hack).max(axis=1) if num_blocks else np.zeros(0, np.int64)
        maxnz = np.maximum(maxnz, 1)

        rows_per_block = np.full(num_blocks, hack, dtype=np.int64)
        if num_blocks:
            rows_per_block[-1] = M - (num_blocks - 1) * hack
        block_sizes = rows_per_block * maxnz
        offsets = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(block_sizes, out=offsets[1:])
        total = int(offsets[-1])

        as_ = np.zeros(total, dtype=csr.values.dtype)

        # destination of each CSR entry: block row-major position
        rows = csr.row_ids().astype(np.int64)
        blk = rows // hack
        local = rows - blk * hack
        within = np.arange(csr.nnz, dtype=np.int64) - csr.row_ptr[:-1].astype(np.int64)[rows]
        dest = offsets[blk] + local * maxnz[blk] + within
        as_[dest] = csr.values

        # padding columns: last valid col per row, 0 for empty rows
        # (reference hll_matrix.c:241-246, last_valid_col calloc'd -> 0)
        last_col = np.zeros(padded_rows, dtype=np.int32)
        rows_idx = np.flatnonzero(row_nnz > 0)
        if rows_idx.size:
            last_col[rows_idx] = csr.col_idx[csr.row_ptr[1:][rows_idx].astype(np.int64) - 1]
        # fill every slot with its row's pad column, then overwrite real entries
        # (the flat layout stores only actual rows: the last block is partial)
        slot_width = np.repeat(maxnz, rows_per_block)  # (M,) maxnz of owning block
        slot_row = np.repeat(np.arange(M, dtype=np.int64), slot_width)
        ja = last_col[slot_row]
        ja[dest] = csr.col_idx

        return cls(
            nrows=M,
            ncols=csr.ncols,
            nnz=csr.nnz,
            hack_size=hack,
            maxnz=maxnz.astype(np.int32),
            offsets=offsets,
            ja=ja,
            as_=as_,
        )

    @classmethod
    def from_coo(cls, coo: COOMatrix, hack_size: int = DEFAULT_HACK_SIZE) -> "HLLMatrix":
        return cls.from_csr(CSRMatrix.from_coo(coo), hack_size)

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Serial HLL SpMV oracle on host (≙ reference spmv_hll_serial,
        src/hll_matrix.c:286-308): per block, per row, sum over MAXNZ slots."""
        x = np.asarray(x, dtype=np.float64)
        y = np.zeros(self.nrows, dtype=np.float64)
        for b in range(self.num_blocks):
            ja, as_ = self.block(b)
            r0 = b * self.hack_size
            y[r0 : r0 + ja.shape[0]] = (as_.astype(np.float64) * x[ja]).sum(axis=1)
        return y

    def to_rect(self, max_elements: int = 1 << 31) -> tuple:
        """Global rectangle (M_padded, K_max) of (JA, AS) for the XLA path.

        Raises if the dense padding would exceed ``max_elements`` (power-law
        guard — SURVEY §3.3 memory blow-up note).
        """
        kmax = int(self.maxnz.max()) if self.num_blocks else 1
        padded_rows = self.num_blocks * self.hack_size
        if padded_rows * kmax > max_elements:
            raise MemoryError(
                f"rectangular HLL view would need {padded_rows * kmax} elements"
            )
        ja = np.zeros((padded_rows, kmax), dtype=np.int32)
        as_ = np.zeros((padded_rows, kmax), dtype=self.as_.dtype)
        for b in range(self.num_blocks):
            bja, bas = self.block(b)
            r0 = b * self.hack_size
            ja[r0 : r0 + bja.shape[0], : bja.shape[1]] = bja
            as_[r0 : r0 + bja.shape[0], : bja.shape[1]] = bas
            # replicate pad col across the widened tail to stay in-bounds
            if bja.shape[1] < kmax:
                ja[r0 : r0 + bja.shape[0], bja.shape[1] :] = bja[:, -1:]
        return ja, as_

    def memory_stats(self) -> dict:
        return {
            "rows": self.nrows,
            "cols": self.ncols,
            "nnz": self.nnz,
            "padded_nnz": self.padded_nnz,
            "padding_ratio": self.padded_nnz / max(self.nnz, 1),
            "bytes_total": self.ja.nbytes + self.as_.nbytes + self.offsets.nbytes
            + self.maxnz.nbytes,
        }
