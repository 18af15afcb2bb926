"""Multi-RHS SELL SpMM in PyTorch: ``Y = A @ X`` for R <= 32 right-hand
sides over k-major and wl bins, each entry read once for all R.

Counterpart of the JAX package's ``ops/pallas_sell_spmm.py``, one CUDA
kernel per layout in ``csrc/sell_spmm.cu``:

* ``k-major`` (``_kernel_k_major_spmm``) -> :func:`k_major_spmm_bin`
* ``wl`` (``_kernel_wl_spmm``) -> :func:`wl_spmm_bin`, reading the
  compacted planes that :func:`..ops.sell.device_put_sell` writes, so one
  :class:`DeviceSell` serves SpMV and SpMM (the JAX kernel reads unpacked
  lane offsets and is wrong on its own default, packed, upload)

Each has a plain PyTorch version (``*_spmm_bin_plain``): values widened to f32,
x and the sums in f32. Both walk each row's slots in the kernel's order with
its rounding (``ops/sell.py``'s ``fma_f32``), so the kernel equals it bit for
bit; the k-major one a few groups at a time, so that a large bin's R-wide
sums never exist at once. The k-major kernel reads the bin's window table
(``ops/sell.py``'s ``_x_window``): blocks whose columns span at most
``window_rows`` x rows stage them in shared memory (:func:`staged_blocks`).
A wrapper given CUDA tensors launches its kernel, or raises; given CPU
tensors it runs the plain version. Each wrapper counts its launches in
``.launches`` and those with ``accumulate=True`` in ``.accumulating``.

The x table (:func:`pack_x_multi`) is X padded to the SpMV table's rows
(``slab_table_rows(ncols)*128``), row-major, so an entry's R values are
contiguous: a ``(rows, R)`` view of a ``(rows, W)`` f32 buffer, W = R
rounded up to 4 (the JAX package stacks R separate tables, ``(R, Rp,
128)``). y is laid out the same way. The wl kernel reads x only at real
columns, so :func:`sell_spmm` hands a raw f32 X whose rows are whole
float4s to a SELL of wl bins only as it is, packing nothing. It runs a
:class:`DeviceSell` (core bins store, then ``add_into`` bins accumulate) or
a :class:`DevicePanelSell` (the raw X packed once into the table of the
panels' rebased columns, ``x_rows`` rows; every bin accumulates).

The JAX function also refuses bins uploaded with resident-y padding, a TPU
grid mode whose sentinel groups only its SpMV kernels skip. The port's
upload never pads, so there is nothing to refuse. Its VMEM x-table budget
and groups-per-step choice are TPU limits and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.sell import GROUP_ROWS, LANES, SUBLANES, slab_table_rows
from . import _build
from .sell import (_CALL, _STAGE_ROWS, DevicePanelSell, DeviceSell,
                   DeviceSellBin, _check_bin, _wl_steps, fma_f32)

__all__ = ["MAX_RHS", "pack_x_multi", "device_put_x_multi",
           "k_major_spmm_bin", "wl_spmm_bin", "k_major_spmm_bin_plain",
           "wl_spmm_bin_plain", "sell_spmm", "sell_spmm_plain",
           "staged_blocks"]

# right-hand sides per call: the kernels keep one f32 sum per RHS in
# registers (templated on 4, 8, 16 or 32 of them)
MAX_RHS = 32
_SPMM_LAYOUTS = ("k-major", "wl")
_PLAIN_ELEMS = 1 << 24  # sums per chunk of groups, plain k-major


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
    return _pack_rows(X, slab_table_rows(ncols) * LANES)


def _pack_rows(X: torch.Tensor, rows: int) -> torch.Tensor:
    """``X (N, R)`` in a zeroed ``(rows, R)`` table laid out as
    :func:`pack_x_multi`'s."""
    if X.shape[0] > rows:
        raise ValueError(f"X has {X.shape[0]} rows, the table {rows}")
    tab = _rhs_buffer(rows, X.shape[1], X.device)
    tab[:X.shape[0]] = X
    return tab


def device_put_x_multi(X, ncols: int, *, device) -> torch.Tensor:
    """Upload a host ``X (N, R)`` as :func:`pack_x_multi`'s table."""
    X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    return pack_x_multi(X.to(device), ncols)


def _whole_rows(t: torch.Tensor, multiple: int) -> bool:
    """Whether 2-D ``t`` is a view of a row-major buffer the kernels can
    read whole 16-byte chunks of: unit column stride, a row stride that is a
    multiple of ``multiple`` elements and at least the width rounded up to
    it, 16-byte aligned, with the buffer's storage behind every row."""
    rows, cols = t.shape
    ld = t.stride(0)
    width = -(-cols // multiple) * multiple
    return not (t.stride(1) != 1 or ld % multiple or ld < width
                or t.data_ptr() % 16
                or (t.storage_offset() + rows * ld) * t.element_size()
                > t.untyped_storage().nbytes())


def _check_rows_view(t: torch.Tensor, name: str, shape: tuple,
                     dtypes: tuple, multiple: int):
    """Check that ``t`` is a ``shape`` view the kernels can read whole
    16-byte chunks of (:func:`_whole_rows`)."""
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be "
                         f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                         f"needs {tuple(shape)}")
    if not _whole_rows(t, multiple):
        width = -(-shape[1] // multiple) * multiple
        raise ValueError(
            f"{name} must be a view of a row-major buffer with a row stride "
            f"that is a multiple of {multiple} (>= {width}) and 16-byte "
            f"aligned rows, got strides {t.stride()}")


def k_major_spmm_bin_plain(b: DeviceSellBin,
                           x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, i, j, r]``: row i*128 + j's K entries ``as[(g*K+k)*8+i, j]``
    in k order, ``acc[r] = fmaf(as, X[ja, r], acc[r])`` from 0
    (:func:`~.sell.fma_f32`), zero values skipped — column r equals
    :func:`~.sell.k_major_bin_plain` on ``X[:, r]`` bit for bit where that
    runs one lane a row. A few groups at a time."""
    rhs = x_tab.shape[1]
    step = max(1, _PLAIN_ELEMS // (GROUP_ROWS * rhs))
    shape = (b.n_groups, b.k, SUBLANES, LANES)
    vals, cols = b.as_.view(shape), b.ja.view(shape)
    out = torch.zeros(b.n_groups, SUBLANES, LANES, rhs, dtype=torch.float32,
                      device=x_tab.device)
    for g0 in range(0, b.n_groups, step):
        acc = out[g0:g0 + step]
        for k in range(b.k):
            v = vals[g0:g0 + step, k]
            new = fma_f32(v.double()[..., None]
                          * x_tab[cols[g0:g0 + step, k].long()].double(), acc)
            acc = torch.where((v != 0)[..., None], new, acc)
        out[g0:g0 + step] = acc
    return out


def staged_blocks(b: DeviceSellBin) -> int:
    """How many of k-major bin ``b``'s blocks the SpMM kernel runs on x
    staged in shared memory (the rest gather from the x table)."""
    if b.window_rows == 0:
        return 0
    return int((b.x_window[:, 1] <= b.window_rows).sum())


def wl_spmm_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, rb, j, r]``: row rb*128 + j's real slots (``_wl_steps``) in
    the kernel's order, ``acc[r] = fmaf(v, X[col, r], acc[r])`` from 0 —
    column r equals :func:`~.sell.wl_bin_plain` on ``X[:, r]`` (the
    compacted planes hold no zero value, so neither skips a slot). A row
    past its length adds nothing, whatever x holds; ``x_tab`` may be the
    raw ``(ncols, R)`` X."""
    rhs = x_tab.shape[1]
    acc = torch.zeros(b.n_groups * GROUP_ROWS, rhs, dtype=torch.float32,
                      device=x_tab.device)
    vals = b.as_.view(-1)
    for pos, cols, has in _wl_steps(b):
        new = fma_f32(vals[pos].double()[:, None] * x_tab[cols].double(),
                      acc)
        acc = torch.where(has[:, None], new, acc)
    return acc.view(b.n_groups, SUBLANES, LANES, rhs)


_PLAIN = {"k-major": k_major_spmm_bin_plain, "wl": wl_spmm_bin_plain}


def _write_plain(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                 accumulate: bool = False):
    rows = y.view(-1, SUBLANES, LANES, y.shape[1])
    idx = b.group_ids.long()
    out = _PLAIN[b.layout](b, x_tab)
    rows[idx] = rows[idx] + out if accumulate else out


def _check_window(b: DeviceSellBin, device):
    """A k-major bin's window table: there, int32, contiguous, one (first
    column, span) pair a block, and a staged span the kernel's shared
    memory is sized for."""
    w = b.x_window
    if w is None:
        raise ValueError("k-major bin without x_window: upload it with "
                         "device_put_sell")
    if (w.device != device or w.dtype != torch.int32
            or not w.is_contiguous()
            or tuple(w.shape) != (b.n_groups * SUBLANES, 2)):
        raise ValueError(f"x_window must be a contiguous ({b.n_groups * 8}, "
                         f"2) int32 table on {device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    if not 0 <= b.window_rows <= _STAGE_ROWS:
        raise ValueError(f"window_rows={b.window_rows} is outside [0, "
                         f"{_STAGE_ROWS}]")


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
    if b.layout == "k-major":
        _check_window(b, device)
        stem = "sell_k_major"
        before = (b.group_ids, b.ja, b.x_window)
        after = (b.n_groups, b.k, b.window_rows)
    else:
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
    """The x table for ``dsell``: the packed table as it is; the raw
    ``(ncols, R)`` X itself where every bin is wl (whose kernel reads x only
    at real columns, all below ``ncols``) and X is f32 with whole float4
    rows (:func:`_whole_rows`: unit column stride, a row stride that is a
    multiple of 4, 16-byte aligned); else the raw X packed."""
    rows = slab_table_rows(dsell.ncols) * LANES
    if X.ndim == 2 and X.shape[0] == dsell.ncols:
        if (X.dtype == torch.float32 and 1 <= X.shape[1] <= MAX_RHS
                and all(b.layout == "wl" for b in dsell.bins)
                and _whole_rows(X, 4)):
            return X
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
        if X.ndim != 2 or X.shape[0] != d.ncols or X.shape[1] > MAX_RHS:
            raise ValueError(f"panel SpMM needs the raw ({d.ncols}, R) X, "
                             f"R <= {MAX_RHS} (the table of the panels' "
                             f"rebased columns is packed here), got "
                             f"{tuple(X.shape)}")
        for p in d.panels:
            _check_layouts(p.bins)
        y = _rhs_buffer(d.num_groups * GROUP_ROWS, X.shape[1], X.device)
        tab = _pack_rows(X, d.x_rows)
        for dsell in d.panels:
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
    :func:`pack_x_multi` / :func:`device_put_x_multi`; a raw X is packed
    into that table, unless every bin is wl and X is f32 with unit column
    stride, a row stride that is a multiple of 4 and 16-byte aligned data
    (a contiguous X at R = 4, 8, ..., 32): then the kernels read it in
    place. Raises
    ``ValueError`` for R > ``MAX_RHS`` and ``NotImplementedError`` for
    other layouts. CUDA tensors run the CUDA kernels, CPU tensors the plain
    versions."""
    return _spmm(d, X, _run_kernel)


def sell_spmm_plain(d, X: torch.Tensor) -> torch.Tensor:
    """:func:`sell_spmm` through the plain versions on any device — the
    reference the kernels are held against."""
    return _spmm(d, X, _write_plain)
