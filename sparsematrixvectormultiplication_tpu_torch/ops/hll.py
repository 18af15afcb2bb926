"""HLL SpMV on the SELL kernels — the hack-size-granular kernel surface.

Counterpart of the JAX package's ``ops/pallas_hll.py``, which has no kernel
of its own: it repacks an HLL matrix into SELL bins and runs the SELL
kernels. The reference benchmarks HLL as a distinct format with its own GPU
kernels (spmv_hll_naive/warp/warp_shared, cuda_src/hll_matrix.cu:346-479),
whose work is set by per-32-row-block MAXNZ padding; :func:`hll_to_sell`
keeps that padding exactly — every row carries its block's MAXNZ slots,
the explicit (last-valid-col, 0.0) padding slots included — so the stage
measures the HLL work profile, not a repacked one. The result uploads with
:func:`.sell.device_put_sell` and runs on the port's SELL kernels
(:func:`.sell.sell_spmv`).
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CSRMatrix
from ..formats.sell import SellMatrix

__all__ = ["hll_to_sell"]


def hll_to_sell(hll, **sell_kwargs) -> SellMatrix:
    """Repack an HLL matrix (this package's or the JAX package's
    ``HLLMatrix``) into SELL bins *including* its padding slots.

    Each row contributes exactly ``maxnz[block]`` entries (reference layout
    hll_matrix.c:235), so per-group K equals the max block MAXNZ in the
    group and the padded area matches HLL's."""
    M = hll.nrows
    counts = np.repeat(
        hll.maxnz.astype(np.int64),
        [hll.block_rows(b) for b in range(hll.num_blocks)],
    )
    row_ptr = np.zeros(M + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    # HLL flat arrays are already row-major per block -> per-row slices align
    csr_like = CSRMatrix(nrows=M, ncols=hll.ncols, row_ptr=row_ptr,
                         col_idx=hll.ja, values=hll.as_)
    return SellMatrix.from_csr(csr_like, **sell_kwargs)

