"""Multi-RHS SELL SpMM in PyTorch: ``Y = A @ X`` for R <= 32 right-hand
sides over k-major and wl bins, each entry read once for all R.

Counterpart of the JAX package's ``ops/pallas_sell_spmm.py``, one CUDA
kernel per layout in ``csrc/sell_spmm.cu``:

* ``k-major`` (``_kernel_k_major_spmm``) -> :func:`k_major_spmm_bin`
* ``wl`` (``_kernel_wl_spmm``) -> :func:`wl_spmm_bin`, reading the packed
  index plane that :func:`..ops.sell.device_put_sell` always writes, so one
  :class:`DeviceSell` serves SpMV and SpMM (the JAX kernel reads unpacked
  lane offsets and is wrong on its own default, packed, upload)

Each has a plain PyTorch version (``*_spmm_bin_plain``): values widened to
f32, x and the sums in f32, the slots decoded by ``ops/sell.py``'s
``_SLOTS`` and summed a few groups at a time, so that a large bin's R-wide
products never exist at once. A wrapper given CUDA tensors launches its
kernel, or raises; given CPU tensors it runs the plain version. Each wrapper
counts its launches in ``.launches`` and those with ``accumulate=True`` in
``.accumulating``.

The x table (:func:`pack_x_multi`) is X padded to the SpMV table's rows
(``slab_table_rows(ncols)*128``), row-major, so an entry's R values are
contiguous: a ``(rows, R)`` view of a ``(rows, W)`` f32 buffer, W = R
rounded up to 4 (the JAX package stacks R separate tables, ``(R, Rp,
128)``). y is laid out the same way. :func:`sell_spmm` runs a
:class:`DeviceSell` (core bins store, then ``add_into`` bins accumulate) or
a :class:`DevicePanelSell` (each panel packs its own x table from the raw
X; every bin accumulates).

The JAX function also refuses bins uploaded with resident-y padding, a TPU
grid mode whose sentinel groups only its SpMV kernels skip. The port's
upload never pads, so there is nothing to refuse. Its VMEM x-table budget
and groups-per-step choice are TPU limits and have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.sell import GROUP_ROWS, LANES, SUBLANES, slab_table_rows
from . import _build
from .sell import (_CALL, _SLOTS, DevicePanelSell, DeviceSell, DeviceSellBin,
                   _check_bin)

__all__ = ["MAX_RHS", "pack_x_multi", "device_put_x_multi",
           "k_major_spmm_bin", "wl_spmm_bin", "k_major_spmm_bin_plain",
           "wl_spmm_bin_plain", "sell_spmm", "sell_spmm_plain"]

# right-hand sides per call: the kernels keep one f32 sum per RHS in
# registers (templated on 4, 8, 16 or 32 of them)
MAX_RHS = 32
_SPMM_LAYOUTS = ("k-major", "wl")
_PLAIN_ELEMS = 1 << 26  # products per chunk of groups in the plain versions


def _width(r: int) -> int:
    """Columns of the row-major buffer behind an R-wide table: R rounded up
    to 4, so that every row is whole float4s."""
    return -(-r // 4) * 4


def _rhs_buffer(rows: int, r: int, device) -> torch.Tensor:
    """A zeroed ``(rows, r)`` f32 view of a row-major ``(rows, _width(r))``
    buffer."""
    return torch.zeros(rows, _width(r), dtype=torch.float32,
                       device=device)[:, :r]


def pack_x_multi(X: torch.Tensor, ncols: int) -> torch.Tensor:
    """Pack ``X (N, R)`` into the x table of the SpMM kernels on X's device:
    f32, zero-padded to ``slab_table_rows(ncols)*128`` rows (pad slots read
    the spare all-zero slab), row-major with rows of ``_width(R)`` floats;
    returned as the ``(rows, R)`` view."""
    if X.ndim != 2:
        raise ValueError(f"X must be (N, R), got {tuple(X.shape)}")
    n, r = X.shape
    if r > MAX_RHS:
        raise ValueError(f"R={r} > MAX_RHS={MAX_RHS}: tile the RHS block")
    rows = slab_table_rows(ncols) * LANES
    if n > rows:
        raise ValueError(f"X has {n} rows, the table for {ncols} columns "
                         f"{rows}")
    tab = _rhs_buffer(rows, r, X.device)
    tab[:n] = X
    return tab


def device_put_x_multi(X, ncols: int, *, device) -> torch.Tensor:
    """Upload a host ``X (N, R)`` as :func:`pack_x_multi`'s table."""
    X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    return pack_x_multi(X.to(device), ncols)


def _check_rows_view(t: torch.Tensor, name: str, shape: tuple,
                     dtypes: tuple, multiple: int):
    """Check that ``t`` is a ``shape`` view of a row-major buffer the
    kernels can read whole 16-byte chunks of: unit column stride, a row
    stride that is a multiple of ``multiple`` elements and at least the
    width rounded up to it, 16-byte aligned, with the buffer's storage
    behind every row."""
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be "
                         f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                         f"needs {tuple(shape)}")
    rows, cols = shape
    ld = t.stride(0)
    width = -(-cols // multiple) * multiple
    if (t.stride(1) != 1 or ld % multiple or ld < width
            or t.data_ptr() % 16
            or (t.storage_offset() + rows * ld) * t.element_size()
            > t.untyped_storage().nbytes()):
        raise ValueError(
            f"{name} must be a view of a row-major buffer with a row stride "
            f"that is a multiple of {multiple} (>= {width}) and 16-byte "
            f"aligned rows, got strides {t.stride()}")


def _group_slice(b: DeviceSellBin, g0: int, g1: int) -> DeviceSellBin:
    """Groups ``g0:g1`` of bin ``b``: every plane and table holds the same
    number of elements per group, in group order."""
    def cut(t):
        return t.view(b.n_groups, -1)[g0:g1].reshape(-1, *t.shape[1:])
    return dataclasses.replace(
        b, n_groups=g1 - g0, group_ids=cut(b.group_ids), ja=cut(b.ja),
        slab_list=cut(b.slab_list), slab_count=cut(b.slab_count),
        as_=cut(b.as_))


def _sums(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``(n_groups, 8, 128, R)`` f32 row sums of bin ``b`` over the R
    columns of ``x_tab``, a few groups at a time."""
    per_group = b.as_.numel() // max(b.n_groups, 1) * x_tab.shape[1]
    step = max(1, _PLAIN_ELEMS // max(per_group, 1))
    out = []
    for g0 in range(0, b.n_groups, step):
        sub = _group_slice(b, g0, min(b.n_groups, g0 + step))
        shape, cols, _, dims = _SLOTS[b.layout](sub)
        prod = sub.as_.view(shape).float()[..., None] * x_tab[cols]
        out.append(prod.sum(dim=dims))
    if not out:
        return torch.zeros(0, SUBLANES, LANES, x_tab.shape[1],
                           device=x_tab.device)
    return torch.cat(out)


def k_major_spmm_bin_plain(b: DeviceSellBin,
                           x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, i, j, r] = sum_k as[(g*K+k)*8+i, j] * X[ja[(g*K+k)*8+i, j],
    r]``."""
    return _sums(b, x_tab)


def wl_spmm_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, rb, j, r] = sum_{w,l,s} as * X[128*slab[g,rb,w,s] + m, r]``
    over the tiles ``t = (rb*NW + w)*L + l`` of group g."""
    return _sums(b, x_tab)


_PLAIN = {"k-major": k_major_spmm_bin_plain, "wl": wl_spmm_bin_plain}


def _write_plain(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                 accumulate: bool = False):
    rows = y.view(-1, SUBLANES, LANES, y.shape[1])
    idx = b.group_ids.long()
    out = _PLAIN[b.layout](b, x_tab)
    rows[idx] = rows[idx] + out if accumulate else out


def _launch(wrapper, b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
            accumulate: bool):
    """Check and launch C entry ``<stem>_spmm_<f32|bf16>`` for bin ``b``;
    count the launch on ``wrapper``."""
    device = x_tab.device
    if device.type != "cuda":
        raise RuntimeError(
            f"SELL SpMM kernels run on CUDA or CPU tensors, not {device}")
    if y.device != device:
        raise ValueError(f"y is on {y.device}, x on {device}")
    _check_bin(b, {"as_": b.as_}, device, (torch.float32, torch.bfloat16))
    r = x_tab.shape[1] if x_tab.ndim == 2 else 0
    if not 1 <= r <= MAX_RHS:
        raise ValueError(f"x must be (rows, R) with 1 <= R <= {MAX_RHS}, got "
                         f"{tuple(x_tab.shape)}")
    _check_rows_view(x_tab, "x", (x_tab.shape[0], r), (torch.float32,), 4)
    _check_rows_view(y, "y", (y.shape[0], r), (torch.float32,), 4)
    if y.shape[0] % GROUP_ROWS:
        raise ValueError("y must hold whole groups of 1024 rows")
    stem, _, before, after = _CALL[b.layout](b)
    name = f"{stem}_spmm_{'bf16' if b.as_.dtype == torch.bfloat16 else 'f32'}"
    with torch.cuda.device(device):
        fn = getattr(_build.load(), name)
        err = fn(*(t.data_ptr() for t in (*before, b.as_, x_tab, y)), *after,
                 _width(r), x_tab.stride(0), y.stride(0), int(accumulate),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    wrapper.accumulating += bool(accumulate)


def _bin(wrapper, b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
         accumulate: bool):
    if x_tab.device.type == "cpu":
        return _write_plain(b, x_tab, y, accumulate)
    _launch(wrapper, b, x_tab, y, accumulate)


def k_major_spmm_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                     accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + i*128 + j`` of ``y``
    (``(num_groups*1024, R)``, laid out as the x table)."""
    _bin(k_major_spmm_bin, b, x_tab, y, accumulate)


def wl_spmm_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + rb*128 + j`` of ``y``."""
    _bin(wl_spmm_bin, b, x_tab, y, accumulate)


_KERNEL = {"k-major": k_major_spmm_bin, "wl": wl_spmm_bin}
for _w in _KERNEL.values():
    _w.launches = 0
    _w.accumulating = 0


def _run_kernel(b: DeviceSellBin, x_tab, y, accumulate: bool):
    _KERNEL[b.layout](b, x_tab, y, accumulate)


def _check_layouts(bins):
    for b in bins:
        if b.layout not in _SPMM_LAYOUTS:
            raise NotImplementedError(
                f"sell_spmm serves {_SPMM_LAYOUTS} bins only (got "
                f"{b.layout!r}); convert with layout='k-major'")


def _x_table(dsell: DeviceSell, X: torch.Tensor) -> torch.Tensor:
    """The raw ``(ncols, R)`` X packed, or the packed table as it is."""
    rows = slab_table_rows(dsell.ncols) * LANES
    if X.ndim == 2 and X.shape[0] == dsell.ncols:
        return pack_x_multi(X, dsell.ncols)
    if X.ndim == 2 and X.shape[0] == rows and X.dtype == torch.float32:
        if X.shape[1] > MAX_RHS:
            raise ValueError(f"R={X.shape[1]} > MAX_RHS={MAX_RHS}")
        return X
    raise ValueError(
        f"X must be the raw ({dsell.ncols}, R) matrix or the f32 table of "
        f"pack_x_multi / device_put_x_multi ({rows} rows), got {X.dtype} "
        f"{tuple(X.shape)}")


def _spmm(d, X: torch.Tensor, write) -> torch.Tensor:
    if isinstance(d, DevicePanelSell):
        if X.ndim != 2 or X.shape[0] != d.ncols:
            raise ValueError(f"panel SpMM needs the raw ({d.ncols}, R) X "
                             f"(tables are packed per panel), got "
                             f"{tuple(X.shape)}")
        for p in d.panels:
            _check_layouts(p.bins)
        y = _rhs_buffer(d.num_groups * GROUP_ROWS, X.shape[1], X.device)
        for p, dsell in enumerate(d.panels):
            c0, c1 = d.bounds[p], d.bounds[p + 1]
            tab = pack_x_multi(X[c0:c1], c1 - c0)
            for b in dsell.bins:
                # panels write the same groups: every bin adds
                write(b, tab, y, True)
        return y[: d.nrows]
    if not isinstance(d, DeviceSell):
        raise TypeError(f"sell_spmm takes a DeviceSell or DevicePanelSell, "
                        f"got {type(d).__name__}")
    _check_layouts(d.bins)
    x_tab = _x_table(d, X)
    y = _rhs_buffer(d.num_groups * GROUP_ROWS, x_tab.shape[1], x_tab.device)
    for accumulate in (False, True):
        for b in d.bins:
            if b.add_into == accumulate:
                write(b, x_tab, y, accumulate)
    return y[: d.nrows]


def sell_spmm(d, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` over k-major and wl bins; returns ``(nrows, R)`` f32 in
    the SELL's row order (sigma-permuted where the SELL is).

    ``d`` is a :class:`DeviceSell` or a :class:`DevicePanelSell`. ``X`` is
    the raw ``(ncols, R)`` matrix or (not for panels) the table of
    :func:`pack_x_multi` / :func:`device_put_x_multi`. Raises
    ``ValueError`` for R > ``MAX_RHS`` and ``NotImplementedError`` for
    other layouts. CUDA tensors run the CUDA kernels, CPU tensors the plain
    versions."""
    return _spmm(d, X, _run_kernel)


def sell_spmm_plain(d, X: torch.Tensor) -> torch.Tensor:
    """:func:`sell_spmm` through the plain versions on any device — the
    reference the kernels are held against."""
    return _spmm(d, X, _write_plain)
