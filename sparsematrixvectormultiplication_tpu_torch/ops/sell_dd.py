"""Double-double SELL-C-128 SpMV in PyTorch: fp64-class results from f32.

Counterpart of the JAX package's ``ops/pallas_sell_dd.py``. Every fp64 value
travels as an f32 ``(hi, lo)`` pair (:mod:`.doubledouble`): the value planes
and the x table are split on the host with :func:`split_f64`, each slot's
product is a ``dd_mul_dd`` and each row's sum a chain of ``dd_add_dd``, and y
comes back as a pair that :func:`combine_f64` joins in fp64. One CUDA kernel
per bin layout, each the dd instantiation of the f32 kernel's source:

* ``k-major`` (``_kernel_k_major_dd``) -> ``csrc/sell_k_major.cu``
  ``sell_k_major_dd``
* ``wl`` (``_kernel_wl_dd``, packed index plane) -> ``csrc/sell_wl.cu``
  ``sell_wl_dd``
* ``sb-major`` / ``sb-list`` (``_kernel_sb_major_dd``, ``_kernel_sb_list_dd``),
  int32 or int16 index planes -> ``csrc/sell_sb.cu``
  ``sell_{sb_major,sb_list}_dd_{i32,i16}``
* ``sg`` rows mode (``_kernel_sg_dd``) -> ``csrc/sell_sg.cu`` ``sell_sg_dd``

The bins share their index planes, tables and column decode with
:mod:`.sell`. Each kernel has a wrapper (``*_bin_dd``) and a plain PyTorch
version (``*_bin_plain_dd``) returning the ``(hi, lo)`` row sums ``(n_groups,
8, 128)``: the same slot products, reduced over each row's entries by a
pairwise tree of ``dd_add_dd``. A wrapper given CUDA tensors launches its
kernel, or raises; given CPU tensors it runs the plain version. Each wrapper
counts its launches in ``.launches``, and those with ``accumulate=True``
(``y = dd_add_dd(y, bin sums)``) also in ``.accumulating``.

Slot-packed sg bins (``sg_slots``) are refused: several slots of one lane
may land on one row there, and the TPU kernels' error-free transforms need
one product per output position; convert with ``sg_slots=False``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.sell import LANES, SUBLANES
from .doubledouble import combine_f64, dd_add_dd, dd_mul_dd, split_f64
from .sell import (DeviceBinIndex, _assemble, _assemble_panels,
                   _check_launch, _check_panel_x, _launch, _put_bin_index,
                   _SLOTS, pack_x_table)

__all__ = [
    "DeviceSellBinDD", "DeviceSellDD", "DevicePanelSellDD",
    "device_put_sell_dd", "device_put_x_dd", "k_major_bin_dd", "wl_bin_dd",
    "sb_major_bin_dd", "sb_list_bin_dd", "sg_bin_dd", "k_major_bin_plain_dd",
    "wl_bin_plain_dd", "sb_major_bin_plain_dd", "sb_list_bin_plain_dd",
    "sg_bin_plain_dd", "sell_spmv_dd", "sell_spmv_dd_plain",
    "panel_sell_spmv_dd", "panel_sell_spmv_dd_plain", "sell_spmv_dd_f64",
]


@dataclass(kw_only=True)
class DeviceSellBinDD(DeviceBinIndex):
    """One rectangular bin on a device with its fp64 values split into two
    f32 planes (see :class:`~.sell.DeviceBinIndex` for the index side)."""

    as_hi: torch.Tensor   # (n_groups*k*8, 128) float32
    as_lo: torch.Tensor   # (n_groups*k*8, 128) float32


@dataclass
class DeviceSellDD:
    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bins: list


@dataclass
class DevicePanelSellDD:
    """Column panels on a device: panel p covers columns
    ``[bounds[p], bounds[p+1])`` and holds its own :class:`DeviceSellDD`."""

    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bounds: tuple
    panels: list


def _put_bin_dd(b, device, sb_i16: bool) -> DeviceSellBinDD:
    if b.layout == "sg" and getattr(b, "sg_slots", False):
        raise ValueError(
            "dd kernels need row-unique sg positions (their error-free "
            "transforms sum at most one product per output); convert with "
            "SellMatrix.from_csr(..., sg_slots=False) for the dd stage")
    hi, lo = split_f64(np.asarray(b.as_, np.float64))
    return DeviceSellBinDD(**_put_bin_index(b, device, sb_i16),
                           as_hi=torch.from_numpy(hi).to(device),
                           as_lo=torch.from_numpy(lo).to(device))


def device_put_sell_dd(sell, *, device, sb_i16=False):
    """Upload a host SELL matrix with its values split into f32 (hi, lo)
    planes (``split_f64`` of the fp64 host values).

    ``sell`` is this package's :class:`~..formats.sell.SellMatrix` or
    :class:`~..formats.sell.PanelSellMatrix` (returns a
    :class:`DevicePanelSellDD`), or the JAX package's host counterparts.
    Index planes are those of :func:`~.sell.device_put_sell`: wl planes
    packed, sb planes int16 with ``sb_i16=True`` where the span fits."""
    if hasattr(sell, "panels"):
        return DevicePanelSellDD(
            int(sell.nrows), int(sell.ncols), int(sell.nnz),
            int(sell.num_groups), tuple(int(c) for c in sell.bounds),
            [device_put_sell_dd(p, device=device, sb_i16=sb_i16)
             for p in sell.panels])
    device = torch.device(device)
    return DeviceSellDD(int(sell.nrows), int(sell.ncols), int(sell.nnz),
                        int(sell.num_groups),
                        [_put_bin_dd(b, device, sb_i16) for b in sell.bins])


def device_put_x_dd(x, ncols: int, *, device):
    """Upload fp64 host x as the padded (hi, lo) pair of f32 x tables."""
    return tuple(pack_x_table(torch.from_numpy(h), ncols).to(device)
                 for h in split_f64(np.asarray(x, np.float64)))


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


def _row_sums_dd(b: DeviceSellBinDD, xh: torch.Tensor, xl: torch.Tensor):
    if b.sg_slots:
        raise ValueError("dd sums need row-unique sg positions (rows mode)")
    shape, cols, keep, dims = _SLOTS[b.layout](b)
    ph, pl = dd_mul_dd(b.as_hi.view(shape), b.as_lo.view(shape), xh[cols],
                       xl[cols])
    if keep is not None:
        ph, pl = torch.where(keep, ph, 0.0), torch.where(keep, pl, 0.0)
    # the summed axes first; the rest is (n_groups, 8, 128) in every layout
    front = tuple(range(len(dims)))
    out = (b.n_groups, SUBLANES, LANES)
    return _dd_sum(ph.movedim(dims, front).reshape(-1, *out),
                   pl.movedim(dims, front).reshape(-1, *out))


def k_major_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.k_major_bin_plain`."""
    return _row_sums_dd(b, xh, xl)


def wl_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.wl_bin_plain`."""
    return _row_sums_dd(b, xh, xl)


def sb_major_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.sb_major_bin_plain`."""
    return _row_sums_dd(b, xh, xl)


def sb_list_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.sb_list_bin_plain`."""
    return _row_sums_dd(b, xh, xl)


def sg_bin_plain_dd(b: DeviceSellBinDD, xh, xl):
    """dd twin of :func:`~.sell.sg_bin_plain`, rows mode only."""
    return _row_sums_dd(b, xh, xl)


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


def _bin_dd(wrapper, b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool):
    if xh.device.type == "cpu":
        return _write_plain_dd(b, xh, xl, yh, yl, accumulate)
    if b.sg_slots:
        raise ValueError("dd kernels need row-unique sg positions (rows mode)")
    _check_launch(b, {"as_hi": b.as_hi, "as_lo": b.as_lo},
                  {"x_hi": xh, "x_lo": xl}, {"y_hi": yh, "y_lo": yl},
                  (torch.float32,))
    _launch(wrapper, b, "dd", (b.as_hi, b.as_lo, xh, xl, yh, yl), accumulate)


def k_major_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                   accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + i*128 + j`` of the y
    pair."""
    _bin_dd(k_major_bin_dd, b, xh, xl, yh, yl, accumulate)


def wl_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + rb*128 + j``."""
    _bin_dd(wl_bin_dd, b, xh, xl, yh, yl, accumulate)


def sb_major_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                    accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + sb*128 + j``."""
    _bin_dd(sb_major_bin_dd, b, xh, xl, yh, yl, accumulate)


def sb_list_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl,
                   accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + sb*128 + j``."""
    _bin_dd(sb_list_bin_dd, b, xh, xl, yh, yl, accumulate)


def sg_bin_dd(b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool = False):
    """Write (or dd-add) bin ``b``'s rows ``gid*1024 + p*128 + j`` (rows
    mode)."""
    _bin_dd(sg_bin_dd, b, xh, xl, yh, yl, accumulate)


_KERNEL_DD = {"k-major": k_major_bin_dd, "wl": wl_bin_dd,
              "sb-major": sb_major_bin_dd, "sb-list": sb_list_bin_dd,
              "sg": sg_bin_dd}
for _w in _KERNEL_DD.values():
    _w.launches = 0
    _w.accumulating = 0


def _run_kernel_dd(b: DeviceSellBinDD, xh, xl, yh, yl, accumulate: bool):
    _KERNEL_DD[b.layout](b, xh, xl, yh, yl, accumulate)


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
    the plain versions."""
    return _spmv_dd(d, xh_tab, xl_tab, _run_kernel_dd)


def sell_spmv_dd_plain(d: DeviceSellDD, xh_tab, xl_tab):
    """:func:`sell_spmv_dd` through the plain versions on any device."""
    return _spmv_dd(d, xh_tab, xl_tab, _write_plain_dd)


def _panel_spmv_dd(dps: DevicePanelSellDD, xh, xl, write):
    if not isinstance(dps, DevicePanelSellDD):
        raise TypeError(f"panel_sell_spmv_dd takes a DevicePanelSellDD, got "
                        f"{type(dps).__name__}")
    for x in (xh, xl):
        _check_panel_x(dps, x)
    return _assemble_panels(dps, (xh, xl), write)


def panel_sell_spmv_dd(dps: DevicePanelSellDD, xh: torch.Tensor,
                       xl: torch.Tensor):
    """``y = A @ x`` in dd over column panels: ``xh``/``xl`` are x's
    unpadded f32 halves on the device; each panel packs its own x tables
    and every bin dd-adds onto one y pair."""
    return _panel_spmv_dd(dps, xh, xl, _run_kernel_dd)


def panel_sell_spmv_dd_plain(dps: DevicePanelSellDD, xh, xl):
    """:func:`panel_sell_spmv_dd` through the plain versions."""
    return _panel_spmv_dd(dps, xh, xl, _write_plain_dd)


def sell_spmv_dd_f64(d, x64: torch.Tensor) -> torch.Tensor:
    """fp64 in, fp64 out: x64 (on the device) is split into f32 halves, run
    through :func:`sell_spmv_dd` (or :func:`panel_sell_spmv_dd` for column
    panels) and the y pair combined in fp64."""
    xh = x64.float()
    xl = (x64 - xh.double()).float()
    if isinstance(d, DevicePanelSellDD):
        return combine_f64(*panel_sell_spmv_dd(d, xh, xl))
    return combine_f64(*sell_spmv_dd(d, pack_x_table(xh, d.ncols),
                                     pack_x_table(xl, d.ncols)))
