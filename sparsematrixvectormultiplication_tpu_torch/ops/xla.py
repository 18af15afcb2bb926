"""CSR SpMV and SpMM in plain PyTorch — the any-device differential twins.

Counterparts of the JAX package's ``ops/xla.py`` ``csr_spmv`` and
``csr_spmm``: gather x (or the rows of X) at each entry's column with
``index_select``, scale by the entry's value and sum the products into
their rows with ``index_add_``. They are correctness references (the BSR
tests hold the dense-block kernels against them), not a fast path.
"""

from __future__ import annotations

import torch

__all__ = ["csr_spmv", "csr_spmm"]


def csr_spmv(values: torch.Tensor, col_idx: torch.Tensor,
             row_ids: torch.Tensor, x: torch.Tensor, *,
             nrows: int) -> torch.Tensor:
    """``y[row_ids[e]] += values[e] * x[col_idx[e]]`` over every entry e
    (``row_ids`` as :meth:`..formats.csr.CSRMatrix.row_ids` gives them)."""
    prod = values * x.index_select(0, col_idx.long())
    return torch.zeros(nrows, dtype=prod.dtype, device=prod.device) \
        .index_add_(0, row_ids.long(), prod)


def csr_spmm(values: torch.Tensor, col_idx: torch.Tensor,
             row_ids: torch.Tensor, X: torch.Tensor, *,
             nrows: int) -> torch.Tensor:
    """Multi-RHS ``Y[row_ids[e], :] += values[e] * X[col_idx[e], :]``;
    returns ``(nrows, X.shape[1])``."""
    prod = values[:, None] * X.index_select(0, col_idx.long())
    return torch.zeros(nrows, X.shape[1], dtype=prod.dtype,
                       device=prod.device).index_add_(0, row_ids.long(), prod)
