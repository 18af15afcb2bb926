"""Double-double SELL-C-128 SpMV in PyTorch: fp64-class results from f32.

Counterpart of the JAX package's ``ops/pallas_sell_dd.py``. Every fp64 value
travels as an f32 ``(hi, lo)`` pair (:mod:`.doubledouble`): the value planes
and the x table are split on the host with :func:`split_f64`, each slot's
product is a ``dd_mul_dd`` and each row's sum a chain of ``dd_add_dd``, and y
comes back as a pair that :func:`combine_f64` joins in fp64. One CUDA kernel
per bin layout, each the dd instantiation of the f32 kernel's source:

* ``k-major`` (``_kernel_k_major_dd``) -> ``csrc/sell_k_major.cu``
  ``sell_k_major_dd`` for bins whose rows split over lanes and, on the
  compacted planes of :func:`~.sell._compact_km` (the bins of one lane a
  row), ``sell_k_major_dd_list``
* ``wl`` (``_kernel_wl_dd``) -> ``csrc/sell_wl.cu`` ``sell_wl_dd``, on the
  compacted planes of :func:`~.sell._compact_wl`
* ``sb-major`` / ``sb-list`` (``_kernel_sb_major_dd``, ``_kernel_sb_list_dd``),
  int32 or int16 index planes -> ``csrc/sell_sb.cu``
  ``sell_sb_major_dd_{i32,i16}``, ``sell_sb_list_dd_i16`` and, on the
  compacted planes of :func:`~.sell._compact_sl`, ``sell_sb_list_dd``
* ``sg`` (``_kernel_sg_dd``), rows mode and, unlike the TPU kernel, slots
  mode -> ``csrc/sell_sg.cu`` ``sell_sg_dd``, on the padded tiles (the f32
  and bf16 sg bins are compacted; the dd ones are not)

The bins share their index planes, tables and column decode with
:mod:`.sell`. k-major (compacted or not), sb-major and padded sb-list bins
keep separate hi and lo value planes; wl, sg and compacted sb-list bins
keep one plane of interleaved (hi, lo) pairs (``as_pair``, one 8-byte load
a slot), and their kernels gather x from one interleaved table
(:func:`pack_x_pair`) that :func:`sell_spmv_dd` builds once per call from
the two halves. :func:`sell_spmv_dd_f64` takes fp64 x and returns fp64 y:
on the card one kernel, :func:`dd_prepare_x` (``csrc/dd_split_join.cu``),
writes the tables its bins read (the pair table, the halves, or both) from
x in one pass, and another, :func:`dd_join_y`, joins the y pair. Whether a
k-major bin is compacted is a function of its
shape (:func:`_km_compacts`), so the upload, the checks and the plain
version agree on it. Each kernel has a wrapper (``*_bin_dd``) and a plain
PyTorch version (``*_bin_plain_dd``) returning the ``(hi, lo)`` row sums
``(n_groups, 8, 128)``: the same slot products, reduced over each row's
entries by a pairwise tree of ``dd_add_dd`` (sb-major) or in the kernel's
own order (k-major, wl, sb-list, sg: bit for bit). A slot whose value is zero (hi and lo both
zero) adds nothing to its row, in every kernel and plain version. A wrapper
given CUDA tensors launches its kernel, or raises; given CPU tensors it runs
the plain version. Each wrapper counts its launches in ``.launches``, and
those with ``accumulate=True`` (``y = dd_add_dd(y, bin sums)``) also in
``.accumulating``.

:func:`sell_spmv_dd` and :func:`panel_sell_spmv_dd` run the launch plan of
:mod:`.sell` (bins that share a kernel in one launch; column panels on one
x table, their slices joined by :func:`panel_reduce_dd`,
``csrc/panel_reduce.cu``, with ``dd_add_dd(acc, slice)`` in slice order).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.sell import GROUP_ROWS, LANES, SUBLANES, slab_table_rows
from ..utils.profiling import annotate
from . import _build
from .doubledouble import combine_f64, dd_add_dd, dd_mul_dd, split_f64
from .sell import (DeviceBinIndex, _assemble,
                   _assemble_panels, _check_launch, _check_panel_x,
                   _check_reduce, _compact_km, _compact_sl, _compact_wl,
                   _k_major_lanes, _lane_join, _lane_split, _launch,
                   _launch_reduce, _list_steps, _on, _plan_of, _put,
                   _put_bin_index, _rebase, _sb_padded, _scratch, _sg_chunks,
                   _sg_slots, _sg_sums, _sl_compacts, _SLOTS, _unsort,
                   _wl_padded, _wl_steps, _x_table, pack_x_table)

__all__ = [
    "DeviceSellBinDD", "DeviceSellDD", "DevicePanelSellDD",
    "device_put_sell_dd", "device_put_x_dd", "k_major_bin_dd", "wl_bin_dd",
    "sb_major_bin_dd", "sb_list_bin_dd", "sg_bin_dd", "k_major_bin_plain_dd",
    "wl_bin_plain_dd", "sb_major_bin_plain_dd", "sb_list_bin_plain_dd",
    "sg_bin_plain_dd", "sell_spmv_dd", "sell_spmv_dd_plain",
    "sell_spmv_dd_launches",
    "panel_sell_spmv_dd", "panel_sell_spmv_dd_plain", "sell_spmv_dd_f64",
    "pack_x_pair", "wl_padded_plain_dd", "sb_list_padded_plain_dd",
    "k_major_padded_plain_dd", "panel_reduce_dd", "panel_reduce_plain_dd",
    "dd_prepare_x", "dd_prepare_x_plain", "dd_join_y", "dd_join_y_plain",
]


def _pairs(b: DeviceBinIndex) -> bool:
    """Whether the bin's values and x travel as (hi, lo) pairs: wl, sg and
    compacted sb-list bins."""
    return b.layout in ("wl", "sg") or (b.layout == "sb-list"
                                        and b.row_table is not None)


def _km_compacts(b) -> bool:
    """Whether k-major bin ``b`` (a host bin or a device bin) is compacted
    in dd (:func:`~.sell._compact_km`): its rows run one lane each
    (:func:`~.sell._k_major_lanes`, a function of its groups and K), where
    every pad slot streamed is a whole slot's bytes; split rows keep their
    padded planes. Both keep hi and lo value planes."""
    return b.layout == "k-major" and _k_major_lanes(b) == 1


@dataclass(kw_only=True)
class DeviceSellBinDD(DeviceBinIndex):
    """One rectangular bin on a device with its fp64 values split into f32
    (hi, lo) pairs (see :class:`~.sell.DeviceBinIndex` for the index side):
    two planes (k-major, sb-major, padded sb-list) or one plane of pairs
    (wl, sg, compacted sb-list)."""

    as_hi: torch.Tensor | None = None    # (n_groups*k*8, 128) float32
    as_lo: torch.Tensor | None = None    # (n_groups*k*8, 128) float32
    as_pair: torch.Tensor | None = None  # (value plane rows, 128, 2) float32


@dataclass
class DeviceSellDD:
    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bins: list
    sigma_sorted: bool = False
    plan: object = None  # the LaunchPlan of ops/sell.py, built at upload


@dataclass
class DevicePanelSellDD:
    """Column panels on a device: panel p covers columns
    ``[bounds[p], bounds[p+1])`` and holds its own :class:`DeviceSellDD`,
    its bins' columns rebased onto the whole x (the x table of
    ``x_rows`` entries)."""

    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bounds: tuple
    panels: list
    sigma_sorted: bool = False
    x_rows: int = 0
    plan: object = None  # the PanelPlan of ops/sell.py, built at upload


def _put_bin_dd(b, device, sb_i16: bool, col0: int = 0) -> DeviceSellBinDD:
    def put(dev):
        index = _put_bin_index(b, dev, sb_i16)
        hi, lo = (torch.from_numpy(v).to(dev)
                  for v in split_f64(np.asarray(b.as_, np.float64)))
        if b.layout == "wl":
            index, (hi, lo) = _compact_wl(index, [hi, lo])
        elif _sl_compacts(index):
            index, (hi, lo) = _compact_sl(index, [hi, lo])
        elif b.layout != "sg":
            if _km_compacts(b):
                index, (hi, lo) = _compact_km(index, [hi, lo])
            return DeviceSellBinDD(**_rebase(index, col0), as_hi=hi,
                                   as_lo=lo)
        return DeviceSellBinDD(**_rebase(index, col0),
                               as_pair=torch.stack([hi, lo], -1))
    return _on(device, put)


def device_put_sell_dd(sell, *, device, sb_i16=False):
    """Upload a host SELL matrix with its values split into f32 (hi, lo)
    planes (``split_f64`` of the fp64 host values).

    ``sell`` is this package's :class:`~..formats.sell.SellMatrix` or
    :class:`~..formats.sell.PanelSellMatrix` (returns a
    :class:`DevicePanelSellDD`), or the JAX package's host counterparts.
    Index planes are those of :func:`~.sell.device_put_sell`: wl bins and
    sb-list bins with int32 planes compacted (a slot is dropped when both
    halves of its value are zero), and so are k-major bins of one lane a
    row (:func:`_km_compacts`); sb planes int16 with ``sb_i16=True`` where
    the span fits; wl, sg and compacted sb-list values as one plane of (hi,
    lo) pairs. Column panels' columns are rebased onto the whole x, and the
    launch plan is built as :func:`~.sell.device_put_sell` builds it."""
    return _put(sell, device, lambda b, dev, c0: _put_bin_dd(b, dev, sb_i16,
                                                            c0),
                DeviceSellDD, DevicePanelSellDD)


def device_put_x_dd(x, ncols: int, *, device):
    """Upload fp64 host x as the padded (hi, lo) pair of f32 x tables."""
    return tuple(pack_x_table(torch.from_numpy(h), ncols).to(device)
                 for h in split_f64(np.asarray(x, np.float64)))


def pack_x_pair(xh_tab: torch.Tensor, xl_tab: torch.Tensor) -> torch.Tensor:
    """The pair bins' x table (:func:`_pairs`): entry c is ``(xh[c],
    xl[c])``, one 8-byte gather. Built as the real view of a complex64
    tensor: one elementwise kernel, where ``torch.stack`` on the last axis
    runs a slower strided copy."""
    return torch.view_as_real(torch.complex(xh_tab, xl_tab))


# ---------------------------------------------------------------------------
# fp64 x in, fp64 y out: the x split and tables, the y join
# ---------------------------------------------------------------------------


def dd_prepare_x_plain(x64: torch.Tensor, rows: int, pair: bool = True,
                       halves: bool = True) -> tuple:
    """fp64 ``x64`` split into f32 halves, ``hi = x.float()`` and ``lo = (x
    - hi.double()).float()``, zero-padded to ``rows`` entries; returns
    ``(x_pair, x_hi, x_lo)``: the :func:`pack_x_pair` table where ``pair``,
    the two padded tables where ``halves``, None for each not asked for."""
    xh = x64.float()
    xl = (x64 - xh.double()).float()
    th, tl = _x_table(xh, rows), _x_table(xl, rows)
    return (pack_x_pair(th, tl) if pair else None,
            *((th, tl) if halves else (None, None)))


def dd_prepare_x(x64: torch.Tensor, rows: int, *, pair: bool = True,
                 halves: bool = True) -> tuple:
    """:func:`dd_prepare_x_plain` as one CUDA kernel (``dd_prepare_x``,
    ``csrc/dd_split_join.cu``) on a CUDA ``x64``, bit for bit, the outputs
    views of one allocation; the plain version on a CPU one. Counts its
    launches in ``.launches``."""
    if x64.device.type == "cpu":
        return dd_prepare_x_plain(x64, rows, pair, halves)
    if x64.dtype != torch.float64 or x64.dim() != 1 \
            or not x64.is_contiguous() or x64.numel() > rows:
        raise ValueError(f"x must be a contiguous fp64 vector of at most "
                         f"{rows} entries, got {x64.dtype} "
                         f"{tuple(x64.shape)}")
    buf = torch.empty(rows * 2 * (pair + halves), dtype=torch.float32,
                      device=x64.device)
    x_pair = buf[: 2 * rows].view(rows, 2) if pair else None
    xh, xl = buf[-2 * rows:].view(2, rows) if halves else (None, None)
    with torch.cuda.device(x64.device):
        err = _build.load().dd_prepare_x(
            x64.data_ptr(), x64.numel(), rows,
            *(None if t is None else t.data_ptr() for t in (x_pair, xh, xl)),
            torch.cuda.current_stream(x64.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dd_prepare_x launch failed: cudaError {err}")
    dd_prepare_x.launches += 1
    return x_pair, xh, xl


def dd_join_y_plain(yh: torch.Tensor, yl: torch.Tensor) -> torch.Tensor:
    """The y pair in fp64: :func:`~.doubledouble.combine_f64`."""
    return combine_f64(yh, yl)


def dd_join_y(yh: torch.Tensor, yl: torch.Tensor) -> torch.Tensor:
    """:func:`dd_join_y_plain` as one CUDA kernel (``dd_join_y``,
    ``csrc/dd_split_join.cu``) on CUDA halves, bit for bit; the plain
    version on CPU ones. Counts its launches in ``.launches``."""
    if yh.device.type == "cpu":
        return dd_join_y_plain(yh, yl)
    if any(t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous()
           or t.device != yh.device for t in (yh, yl)) \
            or yl.numel() != yh.numel():
        raise ValueError("yh and yl must be contiguous f32 vectors of one "
                         "length on one device")
    y = torch.empty(yh.numel(), dtype=torch.float64, device=yh.device)
    with torch.cuda.device(yh.device):
        err = _build.load().dd_join_y(
            yh.data_ptr(), yl.data_ptr(), y.data_ptr(), yh.numel(),
            torch.cuda.current_stream(yh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dd_join_y launch failed: cudaError {err}")
    dd_join_y.launches += 1
    return y


dd_prepare_x.launches = 0
dd_join_y.launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions: (hi, lo) row sums (n_groups, 8, 128) of one bin
# ---------------------------------------------------------------------------


def _dd_sum(h: torch.Tensor, l: torch.Tensor):
    """dd sum over axis 0 by a pairwise tree of ``dd_add_dd``."""
    while h.shape[0] > 1:
        if h.shape[0] % 2:
            h = torch.cat([h, torch.zeros_like(h[:1])])
            l = torch.cat([l, torch.zeros_like(l[:1])])
        n = h.shape[0] // 2
        h, l = dd_add_dd(h[:n], l[:n], h[n:], l[n:])
    return h[0], l[0]


def _nonzero_dd(vh: torch.Tensor, vl: torch.Tensor) -> torch.Tensor:
    """The slots whose (hi, lo) value is not zero: the others add nothing."""
    return (vh != 0) | (vl != 0)


def _row_sums_dd(b: DeviceSellBinDD, xh: torch.Tensor, xl: torch.Tensor):
    shape, cols, keep, dims = _SLOTS[b.layout](b)
    vh, vl = b.as_hi.view(shape), b.as_lo.view(shape)
    ph, pl = dd_mul_dd(vh, vl, xh[cols], xl[cols])
    live = _nonzero_dd(vh, vl)
    if keep is not None:
        live &= keep
    ph, pl = torch.where(live, ph, 0.0), torch.where(live, pl, 0.0)
    # the summed axes first; the rest is (n_groups, 8, 128) in every layout
    front = tuple(range(len(dims)))
    out = (b.n_groups, SUBLANES, LANES)
    return _dd_sum(ph.movedim(dims, front).reshape(-1, *out),
                   pl.movedim(dims, front).reshape(-1, *out))


def _dd_add_step(acc: tuple, prod: tuple) -> tuple:
    return dd_add_dd(*acc, *prod)


def k_major_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.k_major_bin_plain`: each lane's slots that
    are not zero in the kernel's order, ``acc = dd_add_dd(acc, dd_mul_dd(v,
    x[col]))`` from (0, 0), the lanes joined by ``dd_add_dd`` in the
    kernel's tree (:func:`~.sell._lane_join`), or a compacted bin's rows in
    k order (:func:`_list_plain_dd`); so the kernel equals it bit for
    bit."""
    if b.row_table is not None:
        return _list_plain_dd(b, xh, xl)
    lanes = _k_major_lanes(b)
    shape = (b.n_groups, b.k, SUBLANES, LANES)
    vh, vl = (_lane_split(v.view(shape), lanes) for v in (b.as_hi, b.as_lo))
    cols = _lane_split(b.ja.view(shape).long(), lanes)
    h = torch.zeros(b.n_groups, lanes, SUBLANES, LANES, dtype=torch.float32,
                    device=xh.device)
    l = torch.zeros_like(h)
    for st in range(vh.shape[1]):
        c = cols[:, st]
        nh, nl = dd_add_dd(h, l, *dd_mul_dd(vh[:, st], vl[:, st], xh[c],
                                            xl[c]))
        live = _nonzero_dd(vh[:, st], vl[:, st])
        h, l = torch.where(live, nh, h), torch.where(live, nl, l)
    return _lane_join((h, l), _dd_add_step)


def wl_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.wl_bin_plain`: each row's real slots in the
    kernel's order, ``acc = dd_add_dd(acc, dd_mul_dd(v, x[col]))`` from (0,
    0), so the kernel equals it bit for bit."""
    n_rows = b.n_groups * GROUP_ROWS
    h = torch.zeros(n_rows, dtype=torch.float32, device=xh.device)
    l = torch.zeros_like(h)
    vals = b.as_pair.view(-1, 2)
    for pos, cols, has in _wl_steps(b):
        v = vals[pos]
        nh, nl = dd_add_dd(h, l, *dd_mul_dd(v[:, 0], v[:, 1], xh[cols],
                                            xl[cols]))
        live = has & _nonzero_dd(v[:, 0], v[:, 1])
        h, l = torch.where(live, nh, h), torch.where(live, nl, l)
    out = (b.n_groups, SUBLANES, LANES)
    return h.view(out), l.view(out)


def wl_padded_plain_dd(hb, xh, xl):
    """dd twin of :func:`~.sell.wl_padded_plain`: host bin ``hb``'s values
    split as the upload splits them, every one of a row's ``k`` slots, pads
    included, added in the order (w, l, s) by ``dd_add_dd`` from (0, 0)."""
    by_step, cols = _wl_padded(hb, xh.device)
    vh, vl = (by_step(torch.from_numpy(v).to(xh.device))
              for v in split_f64(np.asarray(hb.as_, np.float64)))
    h = torch.zeros(cols.shape[1], dtype=torch.float32, device=xh.device)
    l = torch.zeros_like(h)
    for q in range(cols.shape[0]):
        c = cols[q]
        h, l = dd_add_dd(h, l, *dd_mul_dd(vh[q], vl[q], xh[c], xl[c]))
    out = (hb.n_groups, SUBLANES, LANES)
    return h.view(out), l.view(out)


def sb_major_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.sb_major_bin_plain`."""
    return _row_sums_dd(b, xh, xl)


def _in_order_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell._in_order`: a padded bin's slots along its
    entry axis, ``acc = dd_add_dd(acc, dd_mul_dd(v, x[col]))`` from (0, 0),
    masked slots and zero values skipped."""
    shape, cols, keep, (axis,) = _SLOTS[b.layout](b)
    vh, vl = b.as_hi.view(shape), b.as_lo.view(shape)
    live = _nonzero_dd(vh, vl)
    if keep is not None:
        live &= keep
    h = torch.zeros(shape[:axis] + shape[axis + 1:], dtype=torch.float32,
                    device=xh.device)
    l = torch.zeros_like(h)
    for e in range(shape[axis]):
        c = cols.select(axis, e)
        nh, nl = dd_add_dd(h, l, *dd_mul_dd(vh.select(axis, e),
                                            vl.select(axis, e), xh[c], xl[c]))
        k = live.select(axis, e)
        h, l = torch.where(k, nh, h), torch.where(k, nl, l)
    return h, l


def _list_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell._list_plain`: a compacted bin's sorted rows
    (sb-list: (hi, lo) pairs; k-major: hi and lo planes), each row's slots
    in plane order, ``acc = dd_add_dd(acc, dd_mul_dd(v, x[col]))`` from (0,
    0), zero values skipped; ``(n_groups, 8, 128)`` pairs in row order."""
    h = torch.zeros(b.n_groups * GROUP_ROWS, dtype=torch.float32,
                    device=xh.device)
    l = torch.zeros_like(h)
    vh, vl = ((b.as_pair[..., 0], b.as_pair[..., 1]) if _pairs(b)
              else (b.as_hi, b.as_lo))
    vh, vl, cols = vh.reshape(-1), vl.reshape(-1), b.ja.view(-1)
    for pos, has in _list_steps(b):
        c = cols[pos].long()
        nh, nl = dd_add_dd(h, l, *dd_mul_dd(vh[pos], vl[pos], xh[c], xl[c]))
        live = has & _nonzero_dd(vh[pos], vl[pos])
        h, l = torch.where(live, nh, h), torch.where(live, nl, l)
    return _unsort(b, h), _unsort(b, l)


def sb_list_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.sb_list_bin_plain`: each row's real slots in
    entry order, ``acc = dd_add_dd(acc, dd_mul_dd(v, x[col]))`` from (0,
    0), so the kernel equals it bit for bit."""
    if b.row_table is None:
        return _in_order_dd(b, xh, xl)
    return _list_plain_dd(b, xh, xl)


def k_major_padded_plain_dd(hb, xh, xl):
    """The padded k-major kernel's function of one lane a row, which the
    compaction must keep: host bin ``hb``'s values split as the upload
    splits them, and every one of a row's ``k`` slots, pads included, in k
    order, ``acc = dd_add_dd(acc, dd_mul_dd(v, x'))`` from (0, 0) with
    ``x'`` the slot's x, or (0, 0) where its value is (the stored-zero rule
    as ``csrc/sell_common.cuh`` applies it); ``(n_groups, 8, 128)`` pairs.
    A slot of value (0, 0) adds (0, 0), which leaves the row's normalised
    pair as it was, so :func:`k_major_bin_plain_dd` of the compacted bin
    equals it bit for bit."""
    shape = (hb.n_groups, hb.k, SUBLANES, LANES)
    cols = torch.from_numpy(np.asarray(hb.ja, np.int64)).to(xh.device).view(
        shape)
    vh, vl = (torch.from_numpy(v).to(xh.device).view(shape)
              for v in split_f64(np.asarray(hb.as_, np.float64)))
    h = torch.zeros(hb.n_groups, SUBLANES, LANES, dtype=torch.float32,
                    device=xh.device)
    l = torch.zeros_like(h)
    for e in range(hb.k):
        c = cols[:, e]
        take = _nonzero_dd(vh[:, e], vl[:, e])
        h, l = dd_add_dd(h, l, *dd_mul_dd(vh[:, e], vl[:, e],
                                          torch.where(take, xh[c], 0.0),
                                          torch.where(take, xl[c], 0.0)))
    return h, l


def sb_list_padded_plain_dd(hb, xh, xl):
    """dd twin of :func:`~.sell.sb_list_padded_plain`: host bin ``hb``'s
    values split as the upload splits them, every one of a row's ``k``
    slots, pads included, added in entry order by ``dd_add_dd`` from (0,
    0)."""
    shape, cols = _sb_padded(hb, xh.device)
    vh, vl = (torch.from_numpy(v).to(xh.device).view(shape)
              for v in split_f64(np.asarray(hb.as_, np.float64)))
    h = torch.zeros(hb.n_groups, SUBLANES, LANES, dtype=torch.float32,
                    device=xh.device)
    l = torch.zeros_like(h)
    for e in range(hb.k):
        c = cols[:, :, e]
        h, l = dd_add_dd(h, l, *dd_mul_dd(vh[:, :, e], vl[:, :, e], xh[c],
                                          xl[c]))
    return h, l


def sg_bin_plain_dd(b: DeviceSellBinDD, xh, xl, chunks: int | None = None):
    """dd twin of :func:`~.sell.sg_bin_plain`, slots and rows mode: each
    real slot's ``dd_mul_dd(v, x[col])`` added by ``dd_add_dd`` in the
    kernel's order (:func:`~.sell._sg_sums`), the sums joined by
    ``dd_add_dd``; ``chunks`` defaults to the kernel's."""
    shape, cols, _, _ = _sg_slots(b)
    v = b.as_pair.view(*shape, 2)
    prod = dd_mul_dd(v[..., 0], v[..., 1], xh[cols], xl[cols])
    return _sg_sums(b, prod, _nonzero_dd(v[..., 0], v[..., 1]), _dd_add_step,
                    _dd_add_step, chunks or _sg_chunks(b))


_PLAIN_DD = {"k-major": k_major_bin_plain_dd, "wl": wl_bin_plain_dd,
             "sb-major": sb_major_bin_plain_dd,
             "sb-list": sb_list_bin_plain_dd, "sg": sg_bin_plain_dd}


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch the kernel, CPU tensors run the plain version
# ---------------------------------------------------------------------------


def _write_plain_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                    accumulate: bool = False):
    rows_h, rows_l = yh.view(-1, SUBLANES, LANES), yl.view(-1, SUBLANES, LANES)
    idx = b.group_ids.long()
    h, l = _PLAIN_DD[b.layout](b, xh, xl)
    if accumulate:
        h, l = dd_add_dd(rows_h[idx], rows_l[idx], h, l)
    rows_h[idx] = h
    rows_l[idx] = l


def _bin_dd(wrapper, b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool,
            x_pair):
    if xh.device.type == "cpu":
        return _write_plain_dd(b, xh, xl, yh, yl, accumulate)
    if b.layout == "k-major" and (b.row_table is not None) != _km_compacts(
            b):
        raise ValueError(
            "a k-major dd bin of one lane a row runs on compacted planes, "
            "one split over lanes on padded ones: upload it with "
            "device_put_sell_dd")
    ys = {"y_hi": yh, "y_lo": yl}
    if not _pairs(b):
        _check_launch(b, {"as_hi": b.as_hi, "as_lo": b.as_lo},
                      {"x_hi": xh, "x_lo": xl}, ys, (torch.float32,))
        return _launch(wrapper, b, "dd", (b.as_hi, b.as_lo, xh, xl, yh, yl),
                       accumulate)
    if x_pair is None:
        x_pair = pack_x_pair(xh, xl)
    if tuple(x_pair.shape) != (xh.numel(), 2):
        raise ValueError(f"x_pair must be pack_x_pair of the x tables "
                         f"({xh.numel()}, 2), got {tuple(x_pair.shape)}")
    _check_launch(b, {"as_pair": b.as_pair}, {"x_pair": x_pair}, ys,
                  (torch.float32,), pairs=True)
    _launch(wrapper, b, "dd",
            (b.as_pair, x_pair, yh, yl, *_scratch(b, xh.device, pairs=True)),
            accumulate)


def k_major_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                   accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + i*128 + j`` of the y
    pair."""
    _bin_dd(k_major_bin_dd, b, xh, xl, yh, yl, accumulate, None)


def wl_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool = False,
              *, x_pair=None):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + rb*128 + j``. The
    kernel gathers x from ``x_pair`` (:func:`pack_x_pair` of ``xh``, ``xl``),
    built here when it is not given."""
    _bin_dd(wl_bin_dd, b, xh, xl, yh, yl, accumulate, x_pair)


def sb_major_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                    accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + sb*128 + j``."""
    _bin_dd(sb_major_bin_dd, b, xh, xl, yh, yl, accumulate, None)


def sb_list_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                   accumulate: bool = False, *, x_pair=None):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + sb*128 + j``; a
    compacted bin's kernel gathers x from ``x_pair`` as :func:`wl_bin_dd`'s
    does (a padded int16 bin's reads the two tables)."""
    _bin_dd(sb_list_bin_dd, b, xh, xl, yh, yl, accumulate, x_pair)


def sg_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool = False,
              *, x_pair=None):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + sigma*128 + j``
    (slots mode; rows mode: sigma = p); ``x_pair`` as :func:`wl_bin_dd`."""
    _bin_dd(sg_bin_dd, b, xh, xl, yh, yl, accumulate, x_pair)


_KERNEL_DD = {"k-major": k_major_bin_dd, "wl": wl_bin_dd,
              "sb-major": sb_major_bin_dd, "sb-list": sb_list_bin_dd,
              "sg": sg_bin_dd}
for _w in _KERNEL_DD.values():
    _w.launches = 0
    _w.accumulating = 0


def _kernel_writer(x_pair=None):
    """The kernels' bin writer for one SpMV: the pair bins (:func:`_pairs`)
    gather x from ``x_pair`` where it is given (:func:`dd_prepare_x`), else
    those of one pair of x tables share one :func:`pack_x_pair` table,
    built at the first such bin on the card."""
    tables = {}

    def write(b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool):
        if not _pairs(b):
            return _KERNEL_DD[b.layout](b, xh, xl, yh, yl, accumulate)
        held = tables.get("x", ())
        if x_pair is None and xh.device.type != "cpu" and not (
                held and held[0] is xh and held[1] is xl):
            tables["x"], tables["pair"] = (xh, xl), pack_x_pair(xh, xl)
        _KERNEL_DD[b.layout](b, xh, xl, yh, yl, accumulate,
                             x_pair=tables.get("pair", x_pair))
    return write


def _spmv_dd(d: DeviceSellDD, xh, xl, write):
    if not isinstance(d, DeviceSellDD):
        raise TypeError(f"sell_spmv_dd takes a DeviceSellDD, got "
                        f"{type(d).__name__} (column panels: "
                        "panel_sell_spmv_dd)")
    return _assemble(d, (xh, xl), write)


def sell_spmv_dd(d: DeviceSellDD, xh_tab: torch.Tensor,
                 xl_tab: torch.Tensor):
    """``y = A @ x`` in double-double; returns ``(yh, yl)``, each
    ``[:nrows]``, f32 (join with :func:`combine_f64`).

    ``xh_tab``/``xl_tab`` are x's halves padded by :func:`device_put_x_dd`
    or :func:`~.sell.pack_x_table`. Core bins store their own groups' rows,
    then ``add_into`` bins dd-add onto them (≙ the JAX private-buffer join
    ``dd_add_dd(y, far)``); CUDA tensors run the CUDA kernels, CPU tensors
    the plain versions. The pair bins' interleaved x table is built once per
    call, inside it."""
    return _spmv_dd(d, xh_tab, xl_tab, _kernel_writer())


def sell_spmv_dd_launches(d) -> int:
    """The CUDA launches one :func:`sell_spmv_dd` call queues: the plan's
    joint launches, the zero fills of yh and yl where the core bins do not
    write every group and, with pair bins, the :func:`pack_x_pair` table.
    Column panels (:func:`panel_sell_spmv_dd`): the two x tables' zero
    fills and copies, the pair table, the joint launches and
    :func:`panel_reduce_dd`."""
    plan = _plan_of(d)
    pairs = any(_pairs(j.bin) for j in plan.launches)
    if isinstance(d, DevicePanelSellDD):
        return 4 + pairs + plan.kernels
    return 2 * (plan.covered != d.num_groups) + plan.kernels + pairs


def sell_spmv_dd_plain(d: DeviceSellDD, xh_tab, xl_tab):
    """:func:`sell_spmv_dd` through the plain versions on any device."""
    return _spmv_dd(d, xh_tab, xl_tab, _write_plain_dd)


def _panel_spmv_dd(dps: DevicePanelSellDD, xh, xl, write, reduce):
    if not isinstance(dps, DevicePanelSellDD):
        raise TypeError(f"panel_sell_spmv_dd takes a DevicePanelSellDD, got "
                        f"{type(dps).__name__}")
    for x in (xh, xl):
        _check_panel_x(dps, x)
    return _assemble_panels(dps, (xh, xl), write, reduce)


def panel_reduce_plain_dd(parts_hi: torch.Tensor, parts_lo: torch.Tensor,
                          cover: torch.Tensor) -> tuple:
    """dd twin of :func:`~.sell.panel_reduce_plain`: each row's covered
    slices added in slice order onto (0, 0) by ``dd_add_dd(acc, part)``,
    the accumulation first, as the kernels' accumulating store adds a sum
    onto y; returns ``(yh, yl)``."""
    slices, ng = cover.shape
    ph, pl = (p.view(slices, ng, GROUP_ROWS) for p in (parts_hi, parts_lo))
    h = torch.zeros(ng, GROUP_ROWS, dtype=torch.float32, device=ph.device)
    l = torch.zeros_like(h)
    for s in range(slices):
        nh, nl = dd_add_dd(h, l, ph[s], pl[s])
        take = cover[s].bool()[:, None]
        h, l = torch.where(take, nh, h), torch.where(take, nl, l)
    return h.view(-1), l.view(-1)


def panel_reduce_dd(parts_hi, parts_lo, cover, y_hi, y_lo):
    """The (hi, lo) y of column panels from their slices: the CUDA kernel
    ``panel_reduce_dd`` (``csrc/panel_reduce.cu``) on CUDA tensors,
    :func:`panel_reduce_plain_dd` on CPU ones; counts its launches in
    ``.launches``."""
    if y_hi.device.type == "cpu":
        return _reduce_plain_dd(parts_hi, parts_lo, cover, y_hi, y_lo)
    _check_reduce((parts_hi, parts_lo), cover, (y_hi, y_lo))
    _launch_reduce(panel_reduce_dd, "panel_reduce_dd", (parts_hi, parts_lo),
                   cover, (y_hi, y_lo))


panel_reduce_dd.launches = 0


def _reduce_plain_dd(parts_hi, parts_lo, cover, y_hi, y_lo):
    for y, v in zip((y_hi, y_lo),
                    panel_reduce_plain_dd(parts_hi, parts_lo, cover)):
        y.copy_(v)


def panel_sell_spmv_dd(dps: DevicePanelSellDD, xh: torch.Tensor,
                       xl: torch.Tensor):
    """``y = A @ x`` in dd over column panels: ``xh``/``xl`` are x's
    unpadded f32 halves on the device, packed once (with one interleaved
    pair table); the plan's joint launches write each panel's partial rows
    into their slices and :func:`panel_reduce_dd` adds them into the y
    pair in the order of a panel-by-panel accumulation."""
    return _panel_spmv_dd(dps, xh, xl, _kernel_writer(), panel_reduce_dd)


def panel_sell_spmv_dd_plain(dps: DevicePanelSellDD, xh, xl):
    """:func:`panel_sell_spmv_dd` through the plain versions."""
    return _panel_spmv_dd(dps, xh, xl, _write_plain_dd, _reduce_plain_dd)


def _x_reads(plan) -> tuple:
    """``(pair, halves)``: whether ``plan``'s launches gather x from the
    interleaved pair table (a pair bin, :func:`_pairs`) and from the two
    halves (any other bin); worked out at a plan's first dd call and kept
    on it (``LaunchPlan.dd_x``)."""
    if plan.dd_x is None:
        pairs = [_pairs(j.bin) for j in plan.launches]
        plan.dd_x = (any(pairs), not all(pairs))
    return plan.dd_x


def _check_x64(d, x64: torch.Tensor):
    if not isinstance(d, (DeviceSellDD, DevicePanelSellDD)):
        raise TypeError(f"sell_spmv_dd_f64 takes a DeviceSellDD or a "
                        f"DevicePanelSellDD, got {type(d).__name__}")
    if x64.dtype != torch.float64 or tuple(x64.shape) != (d.ncols,) \
            or not x64.is_contiguous():
        raise ValueError(f"x must be a contiguous fp64 vector of {d.ncols} "
                         f"entries, got {x64.dtype} {tuple(x64.shape)}")


def _split_x(d, x64: torch.Tensor, plan) -> tuple:
    """x64 as ``d`` reads it, by :func:`dd_prepare_x` in one pass: column
    panels (``plan`` None) the unpadded halves :func:`panel_sell_spmv_dd`
    packs; a flat SELL of launch plan ``plan`` the padded tables its bins
    gather from (:func:`_x_reads`). Returns ``(x_pair, xh, xl)``; with pair
    bins alone, xh and xl are the pair table's columns, which no kernel
    reads."""
    if plan is None:
        return dd_prepare_x(x64, d.ncols, pair=False)
    pair, halves = _x_reads(plan)
    x_pair, xh, xl = dd_prepare_x(x64, slab_table_rows(d.ncols) * LANES,
                                  pair=pair, halves=halves)
    if xh is None:
        xh, xl = x_pair.unbind(1)
    return x_pair, xh, xl


def sell_spmv_dd_f64(d, x64: torch.Tensor) -> torch.Tensor:
    """fp64 in, fp64 out: x64 (``d.ncols`` entries, contiguous, on the
    device) is split into the f32 x tables of ``d``'s bins
    (:func:`dd_prepare_x`), run through :func:`sell_spmv_dd` (or
    :func:`panel_sell_spmv_dd` for column panels) and the y pair joined in
    fp64 (:func:`dd_join_y`): on the card, one kernel before the plan's
    launches and one after."""
    with annotate("ops.sell_spmv_dd_f64"):
        _check_x64(d, x64)
        panels = isinstance(d, DevicePanelSellDD)
        plan = None if panels else _plan_of(d)
        with annotate("ops.dd.split_x"):
            x_pair, xh, xl = _split_x(d, x64, plan)
        with annotate("ops.dd.assemble"):
            yh, yl = (panel_sell_spmv_dd(d, xh, xl) if panels else _assemble(
                d, (xh, xl), _kernel_writer(x_pair), plan))
        with annotate("ops.dd.join_y"):
            return dd_join_y(yh, yl)
