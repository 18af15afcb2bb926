"""CSR, ELL and SELL SpMV in plain PyTorch — the any-device differential twins.

Counterparts of the JAX package's ``ops/xla.py``, which computes them with
XLA outside any Pallas kernel, so they stay plain PyTorch here:

* ``csr_spmv`` / ``csr_spmm``: gather x (or the rows of X) at each entry's
  column with ``index_select``, scale by the entry's value and sum the
  products into their rows with ``index_add_``;
* ``ell_spmv``: the padded ELL rectangle of an HLL matrix, ``y[i] = sum_k
  as[i, k] * x[ja[i, k]]``;
* ``sell_spmv_xla``: SELL-C-128 by plain gathers over the k-major and
  sb-major bins (int32 planes) only;
* ``DeviceCSR`` / ``device_put_csr`` and ``DeviceELL`` / ``device_put_ell``:
  the uploads the harness's ``csr`` and ``ell`` stages time.

They are correctness references and the bench's CSR/ELL yardsticks, not a
fast path. Two departures from the JAX module, both deliberate:

* ``sell_spmv_xla`` raises on a layout other than k-major or sb-major (the
  JAX version decodes every other layout as sb-major) and adds the rows of
  ``add_into`` bins onto those their core bins wrote (the JAX version
  overwrites them);
* the upload guard is the card's: an upload whose working set (its arrays
  plus one call's temporaries) exceeds ``MAX_UPLOAD_BYTES`` raises
  ``MemoryError``, which the harness records as a skipped stage. The JAX
  guard (1200 MiB per array) was the TPU worker's crash threshold.

Values and x are stored in the upload's dtype (f32, bf16 or f64, as the JAX
uploads store them); products and sums are f32 for f32 and bf16 storage
(bf16 widened on use, as the kernels do) and f64 for f64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.sell import LANES, SUBLANES

__all__ = [
    "csr_spmv",
    "csr_spmm",
    "ell_spmv",
    "sell_spmv_xla",
    "DeviceCSR",
    "DeviceELL",
    "device_put_csr",
    "device_put_ell",
    "MAX_UPLOAD_BYTES",
]

# an upload's working set above this many bytes raises MemoryError: 32 GiB,
# under half of an 80 GB H100's memory, so one stage cannot starve the next
MAX_UPLOAD_BYTES = 32 << 30


def csr_spmv(values: torch.Tensor, col_idx: torch.Tensor,
             row_ids: torch.Tensor, x: torch.Tensor, *,
             nrows: int) -> torch.Tensor:
    """``y[row_ids[e]] += values[e] * x[col_idx[e]]`` over every entry e
    (``row_ids`` as :meth:`..formats.csr.CSRMatrix.row_ids` gives them;
    int32 or int64 indices)."""
    prod = values * x.index_select(0, col_idx)
    return torch.zeros(nrows, dtype=prod.dtype, device=prod.device) \
        .index_add_(0, row_ids, prod)


def csr_spmm(values: torch.Tensor, col_idx: torch.Tensor,
             row_ids: torch.Tensor, X: torch.Tensor, *,
             nrows: int) -> torch.Tensor:
    """Multi-RHS ``Y[row_ids[e], :] += values[e] * X[col_idx[e], :]``;
    returns ``(nrows, X.shape[1])``."""
    prod = values[:, None] * X.index_select(0, col_idx)
    return torch.zeros(nrows, X.shape[1], dtype=prod.dtype,
                       device=prod.device).index_add_(0, row_ids, prod)


def ell_spmv(ja: torch.Tensor, as_: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Padded-ELL SpMV over a rectangle: ``y[i] = sum_k as_[i,k] *
    x[ja[i,k]]``. Padding entries carry ``as_ == 0`` and an in-bounds
    column (reference hll_matrix.c:241-246), so they contribute nothing."""
    return (as_ * x[ja]).sum(dim=1)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type products and sums are taken in for values of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


_SELL_XLA_LAYOUTS = ("k-major", "sb-major")


def sell_spmv_xla(dsell, x_tab: torch.Tensor) -> torch.Tensor:
    """SELL-C-128 SpMV by plain gathers over a :class:`.sell.DeviceSell`
    whose bins are all k-major or sb-major with int32 column planes;
    returns all ``num_groups*1024`` rows (the JAX version's shape). Core
    bins store their groups' rows, then ``add_into`` bins add onto them.
    Raises ``ValueError`` for any other layout or index plane."""
    for b in dsell.bins:
        if b.layout not in _SELL_XLA_LAYOUTS or b.ja.dtype != torch.int32:
            raise ValueError(
                f"sell_spmv_xla decodes k-major and sb-major bins with int32 "
                f"planes, not a {b.layout} bin with {b.ja.dtype} indices")
    y = torch.zeros(dsell.num_groups * SUBLANES, LANES, dtype=x_tab.dtype,
                    device=x_tab.device)
    x_flat = x_tab.reshape(-1)
    for add in (False, True):
        for b in dsell.bins:
            if b.add_into != add:
                continue
            ng, K = b.n_groups, b.k
            if b.layout == "k-major":
                shape, dim = (ng, K, SUBLANES, LANES), 1
            else:
                shape, dim = (ng, SUBLANES, K, LANES), 2
            contrib = (b.as_.view(shape).to(x_tab.dtype)
                       * x_flat[b.ja.view(shape)]).sum(dim=dim)
            rows = (b.group_ids.long()[:, None] * SUBLANES
                    + torch.arange(SUBLANES, device=y.device)).reshape(-1)
            contrib = contrib.reshape(ng * SUBLANES, LANES)
            y[rows] = y[rows] + contrib if add else contrib
    return y.reshape(-1)


# --------------------------------------------------------------------------
# device-resident containers (≙ the reference's cudaMalloc/Memcpy upload
# layer, main_cuda.cu:134-145 / 376-402)
# --------------------------------------------------------------------------


def _check_upload(nbytes: int, what: str):
    if nbytes > MAX_UPLOAD_BYTES:
        raise MemoryError(
            f"{what} needs {nbytes / 2**20:.0f} MiB > "
            f"{MAX_UPLOAD_BYTES / 2**20:.0f} MiB (MAX_UPLOAD_BYTES); "
            "stage skipped")


@dataclass
class DeviceCSR:
    """CSR arrays on a device: values in the upload's dtype, int32 columns
    and the expanded int32 row index of every entry."""

    values: torch.Tensor
    col_idx: torch.Tensor
    row_ids: torch.Tensor
    nrows: int
    ncols: int

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A @ x`` (``x`` 1-D on the same device), in the type of the
        sums (f32, or f64 for f64 values)."""
        acc = _acc_dtype(self.values.dtype)
        return csr_spmv(self.values.to(acc), self.col_idx, self.row_ids,
                        x.to(acc), nrows=self.nrows)


@dataclass
class DeviceELL:
    """The rectangular padded ELL view of an HLL matrix on a device."""

    ja: torch.Tensor
    as_: torch.Tensor
    nrows: int
    ncols: int
    nnz: int

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        acc = _acc_dtype(self.as_.dtype)
        return ell_spmv(self.ja, self.as_.to(acc), x.to(acc))[: self.nrows]


def device_put_csr(csr, dtype=torch.float32, *, device) -> DeviceCSR:
    """Upload a host CSR matrix (this package's or the JAX package's
    ``CSRMatrix``: only its attributes and ``row_ids()`` are read) with
    values in ``dtype``."""
    acc = _acc_dtype(dtype).itemsize
    # the arrays, plus one call's gathered x and products
    _check_upload(int(csr.nnz) * (dtype.itemsize + 8 + 2 * acc),
                  "the CSR upload")
    ints = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.int32)).to(device)
    return DeviceCSR(
        torch.from_numpy(np.ascontiguousarray(csr.values)).to(dtype)
        .to(device), ints(csr.col_idx), ints(csr.row_ids()),
        int(csr.nrows), int(csr.ncols))


def device_put_ell(hll, dtype=torch.float32, *, device,
                   max_elements: int = 1 << 31) -> DeviceELL:
    """Upload the rectangle of a host HLL matrix (this package's or the JAX
    package's ``HLLMatrix``); ``hll.to_rect`` raises ``MemoryError`` past
    ``max_elements``."""
    ja, as_ = hll.to_rect(max_elements=max_elements)
    acc = _acc_dtype(dtype).itemsize
    _check_upload(int(ja.size) * (dtype.itemsize + 4 + 2 * acc),
                  "the ELL rectangle")
    return DeviceELL(
        torch.from_numpy(np.ascontiguousarray(ja, np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(as_)).to(dtype).to(device),
        int(hll.nrows), int(hll.ncols), int(hll.nnz))
