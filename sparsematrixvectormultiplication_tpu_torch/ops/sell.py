"""SELL-C-128 SpMV in PyTorch: upload, per-bin kernels and their plain twins.

Counterpart of the JAX package's ``ops/pallas_sell.py``, one CUDA kernel per
bin layout:

* ``k-major`` (``_kernel_k_major``) -> ``csrc/sell_k_major.cu``
* ``wl`` window-layered (``_kernel_wl``, packed index plane) -> ``csrc/sell_wl.cu``
* ``sb-major`` and ``sb-list`` (``_kernel_sb_major``, ``_kernel_sb_list``),
  int32 or int16 index planes -> ``csrc/sell_sb.cu``
* ``sg`` shared-window tiles (``_kernel_sg``), slots or rows mode, static or
  dynamic pass tables -> ``csrc/sell_sg.cu``

Each kernel has a wrapper (:func:`k_major_bin`, :func:`wl_bin`,
:func:`sb_major_bin`, :func:`sb_list_bin`, :func:`sg_bin`) and a plain
PyTorch version (``*_bin_plain``) computing the same function: values
widened to f32, x and the sums in f32. A wrapper given CUDA tensors launches
its kernel, or raises; given CPU tensors it runs the plain version. Each
wrapper counts its kernel launches in ``.launches``, and those made with
``accumulate=True`` (the bin's sums added onto y instead of stored) also in
``.accumulating``.

:func:`sell_spmv` runs a :class:`DeviceSell`: the core bins store their
rows, then every ``add_into`` bin (the sg far remainder) accumulates onto
them, on the same stream — the JAX "auto" assembly. :func:`panel_sell_spmv`
runs a :class:`DevicePanelSell` (column panels): one y, one padded x table
per panel, every bin accumulating.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.sell import CHUNK_K, GROUP_ROWS, LANES, SUBLANES, slab_table_rows
from . import _build

__all__ = [
    "DeviceBinIndex", "DeviceSellBin", "DeviceSell", "DevicePanelSell",
    "device_put_sell", "device_put_x", "pack_x_table", "k_major_bin",
    "wl_bin", "sb_major_bin", "sb_list_bin", "sg_bin", "k_major_bin_plain",
    "wl_bin_plain", "sb_major_bin_plain", "sb_list_bin_plain", "sg_bin_plain",
    "sell_spmv", "sell_spmv_plain", "panel_sell_spmv", "panel_sell_spmv_plain",
]

_INT32_MAX = 2**31 - 1
_SB_LAYOUTS = ("sb-major", "sb-list")
_SB_I16_MAX_SPAN = 255  # the int16 planes hold dq or js in 8 bits


@dataclass(kw_only=True)
class DeviceBinIndex:
    """The index side of one rectangular bin on a device, shared by the f32
    bins here and the double-double bins of :mod:`.sell_dd`.

    Every layout's value plane is ``(n_groups*k*8, 128)``.

    * ``k-major``: ``ja`` holds absolute columns; entry e of row i*128+j of
      group g at row ``(g*k + e)*8 + i``. ``slab_list`` is not read.
    * ``sb-major`` / ``sb-list``: entry e of row sb*128+j at row
      ``g*8k + sb*k + e``, in chunks of ``chunk_k`` entries. ``ja`` holds
      absolute columns (int32) or the int16 planes of
      :func:`_pack_sb_i16` / :func:`_pack_sl_i16`. ``slab_list`` is the
      per-chunk qbase table ``(n_groups, 8*k/chunk_k)`` (sb-major) or the
      per-chunk distinct-slab lists ``(n_groups, 8*k/chunk_k*span)``.
    * ``wl``: ``k = 8*nw*L`` with ``nw = chunk_k`` windows and ``L = span``
      layer tiles; ``ja`` is the packed lane-index plane
      ``(n_groups*Tp*8, 128)``, ``Tp = ceil(8*nw*L/4)``; ``slab_list`` the
      ``(n_groups, 8*nw*8)`` window slab ids.
    * ``sg``: ``k`` tiles per group; ``ja`` holds ``md``; ``slab_list`` the
      ``(n_groups, k*stride)`` window bases (stride 2 when ``span == 0``:
      dynamic bins also carry pass counts); ``slab_count`` the real tiles.
    """

    layout: str
    k: int
    n_groups: int
    group_ids: torch.Tensor   # (n_groups,) int32
    ja: torch.Tensor          # int32 | int16 (sb layouts)
    slab_list: torch.Tensor   # int32, layout's table (see above)
    slab_count: torch.Tensor  # (n_groups,) int32
    span: int = 0
    chunk_k: int = CHUNK_K
    add_into: bool = False    # accumulates onto rows another bin wrote
    sg_slots: bool = False    # sg: destination row from md's sigma bits

    @property
    def nw(self) -> int:
        """wl: windows per row-block."""
        return self.chunk_k

    @property
    def L(self) -> int:
        """wl: layer tiles per window."""
        return self.span


@dataclass(kw_only=True)
class DeviceSellBin(DeviceBinIndex):
    """One rectangular bin on a device with f32 or bf16 values."""

    as_: torch.Tensor         # (n_groups*k*8, 128) float32 | bfloat16


@dataclass
class DeviceSell:
    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bins: list


@dataclass
class DevicePanelSell:
    """Column panels on a device: panel p covers columns
    ``[bounds[p], bounds[p+1])`` and holds its own :class:`DeviceSell`."""

    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bounds: tuple
    panels: list


def _pack_wl_ja(ja_h: np.ndarray, rows_per_group: int) -> np.ndarray:
    """Pack a wl bin's lane-index plane 4 tiles -> 1 int32 tile, per group:
    (8,128) tile ``t`` lands in byte ``t % 4`` of packed tile ``t // 4``; the
    per-group tile count pads to a multiple of 4 with zero tiles. Lane
    indices are 0..127, so the top byte stays <= 0x7F and the int32 view is
    never negative."""
    ng = ja_h.shape[0] // rows_per_group
    Tn = rows_per_group // 8
    Tp = -(-Tn // 4)
    tiles = ja_h.reshape(ng, Tn, 8, LANES).astype(np.uint32)
    if Tp * 4 != Tn:
        tiles = np.concatenate(
            [tiles, np.zeros((ng, Tp * 4 - Tn, 8, LANES), np.uint32)], axis=1)
    tiles = tiles.reshape(ng, Tp, 4, 8, LANES)
    packed = (tiles[:, :, 0]
              | (tiles[:, :, 1] << np.uint32(8))
              | (tiles[:, :, 2] << np.uint32(16))
              | (tiles[:, :, 3] << np.uint32(24)))
    return packed.reshape(ng * Tp * 8, LANES).astype(np.int32)


def _pack_sb_i16(ja_h: np.ndarray, sl_h: np.ndarray, ng: int, K: int,
                 ck: int, span: int) -> np.ndarray:
    """(rows,128) absolute-column sb-major plane -> int16 ``(dq<<7)|m``
    plane, ``dq = slab - qbase`` of the entry's chunk (clipped to
    [-1, 255]; -1 marks a pad, whose value is 0)."""
    rows = ja_h.shape[0]
    kb = SUBLANES * K
    assert rows == ng * kb, (rows, ng, K)
    nchunks = K // ck
    q = (ja_h.astype(np.int64) >> 7)
    m = ja_h & (LANES - 1)
    r = np.arange(rows, dtype=np.int64)
    g_of = r // kb
    sb_of = (r % kb) // K
    c_of = (r % K) // ck
    qb = np.asarray(sl_h).reshape(ng, -1)[g_of, sb_of * nchunks + c_of]
    dq = np.clip(q - qb[:, None], -1, 255)
    return ((dq << 7) | m).astype(np.int16)


def _pack_sl_i16(ja_h: np.ndarray, lst_h: np.ndarray, ng: int, K: int,
                 ck: int, span: int) -> np.ndarray:
    """sb-list twin of :func:`_pack_sb_i16`: ``(js<<7)|m`` with ``js`` the
    slab's position in its chunk's sorted distinct list (-1: a pad)."""
    rows = ja_h.shape[0]
    kb = SUBLANES * K
    assert rows == ng * kb, (rows, ng, K)
    nchunks = K // ck
    q = (ja_h.astype(np.int32) >> 7)
    m = ja_h & (LANES - 1)
    r = np.arange(rows, dtype=np.int64)
    chunk_of = ((r // kb) * SUBLANES * nchunks
                + ((r % kb) // K) * nchunks
                + (r % K) // ck)
    lists2 = np.asarray(lst_h, np.int32).reshape(ng * SUBLANES * nchunks,
                                                 span)
    js = np.empty((rows, LANES), np.int16)
    blk = max(1, (1 << 22) // max(span, 1))   # bound the temporary
    for a in range(0, rows, blk):
        z = min(rows, a + blk)
        lr = lists2[chunk_of[a:z]]            # (B, span) sorted ascending
        js[a:z] = ((lr[:, None, :] <= q[a:z, :, None]).sum(-1) - 1
                   ).astype(np.int16)
    return ((js.astype(np.int32) << 7) | m).astype(np.int16)


def _values(a: np.ndarray, dtype, device) -> torch.Tensor:
    # f64 host values narrow straight to the device dtype (bf16 rounds the
    # way ml_dtypes and the JAX upload do)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)


def _ints(a, device, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype))).to(device)


def _put_bin_index(b, device, sb_i16: bool) -> dict:
    """The :class:`DeviceBinIndex` fields of host bin ``b`` on ``device``
    (wl planes packed; sb planes int16 with ``sb_i16`` where the span fits)."""
    if b.layout not in _KERNEL:
        raise ValueError(f"unknown SELL bin layout {b.layout!r}; the port "
                         f"runs {', '.join(_KERNEL)}")
    ng, k = int(b.n_groups), int(b.k)
    span = int(getattr(b, "span", 0))
    ck = int(getattr(b, "chunk_k", CHUNK_K))
    ja, table = np.asarray(b.ja), np.asarray(b.slab_list)
    if b.layout == "wl":
        if k != 8 * ck * span:
            raise ValueError(f"wl bin k={k} != 8*NW*L = 8*{ck}*{span}")
        ja = _pack_wl_ja(ja, k * SUBLANES)
    elif b.layout == "k-major":
        table = np.zeros(0, np.int32)  # the kernel gathers x[ja] directly
    elif b.layout in _SB_LAYOUTS:
        if k % ck:
            raise ValueError(f"{b.layout} bin k={k} is not a multiple of "
                             f"chunk_k={ck}")
        if sb_i16 and span <= _SB_I16_MAX_SPAN:
            pack = _pack_sb_i16 if b.layout == "sb-major" else _pack_sl_i16
            ja = pack(ja, table, ng, k, ck, span)
    return dict(
        layout=b.layout, k=k, n_groups=ng,
        group_ids=_ints(b.group_ids, device),
        ja=_ints(ja, device, np.int16 if ja.dtype == np.int16 else np.int32),
        slab_list=_ints(table.reshape(-1), device),
        slab_count=_ints(np.asarray(b.slab_count).reshape(-1), device),
        span=span, chunk_k=ck, add_into=bool(getattr(b, "add_into", False)),
        sg_slots=bool(getattr(b, "sg_slots", False)))


def device_put_sell(sell, dtype=torch.float32, *, device, sb_i16=False):
    """Upload a host SELL matrix to ``device``.

    ``sell`` is this package's :class:`~..formats.sell.SellMatrix` or
    :class:`~..formats.sell.PanelSellMatrix` (returns a
    :class:`DevicePanelSell`), or the JAX package's host counterparts: only
    bin attributes are read. wl index planes are always packed 4 lane bytes
    per int32. ``sb_i16=True`` stores sb-major and sb-list index planes as
    int16 (as the JAX package's ``SPMV_SB_I16=1`` does) for bins whose span
    fits 8 bits; other bins keep int32 columns."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value dtype {dtype} not supported "
                         "(torch.float32 or torch.bfloat16)")
    if hasattr(sell, "panels"):
        return DevicePanelSell(
            int(sell.nrows), int(sell.ncols), int(sell.nnz),
            int(sell.num_groups), tuple(int(c) for c in sell.bounds),
            [device_put_sell(p, dtype, device=device, sb_i16=sb_i16)
             for p in sell.panels])
    device = torch.device(device)
    return DeviceSell(int(sell.nrows), int(sell.ncols), int(sell.nnz),
                      int(sell.num_groups),
                      [DeviceSellBin(**_put_bin_index(b, device, sb_i16),
                                     as_=_values(b.as_, dtype, device))
                       for b in sell.bins])


def pack_x_table(x: torch.Tensor, ncols: int) -> torch.Tensor:
    """x as f32, zero-padded to ``slab_table_rows(ncols)*128`` entries: pad
    slots gather from the spare all-zero slab past the last column."""
    n = slab_table_rows(ncols) * LANES
    tab = torch.zeros(n, dtype=torch.float32, device=x.device)
    tab[: x.shape[0]] = x
    return tab


def device_put_x(x, ncols: int, *, device) -> torch.Tensor:
    """Upload a host vector pre-padded as :func:`pack_x_table` lays it out."""
    return pack_x_table(torch.as_tensor(np.asarray(x)), ncols).to(device)


# ---------------------------------------------------------------------------
# column decode: each slot's plane position and x index, shared by the plain
# f32 versions here and the plain dd versions of .sell_dd
# ---------------------------------------------------------------------------


def _k_major_slots(b: DeviceBinIndex):
    """Entry k of row i*128+j of group g at plane row ``(g*K + k)*8 + i``
    gathers ``x[ja]``."""
    shape = (b.n_groups, b.k, SUBLANES, LANES)
    return shape, b.ja.view(shape).long(), None, (1,)


def _unpack_wl_ja(b: DeviceBinIndex) -> torch.Tensor:
    """Packed plane -> lane indices m, shaped (ng, 8 rb, NW, L, 8 s, 128)."""
    ng, Tn = b.n_groups, SUBLANES * b.nw * b.L
    Tp = -(-Tn // 4)
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=b.ja.device)
    m = (b.ja.view(ng, Tp, 1, 8, LANES) >> shifts.view(1, 1, 4, 1, 1)) \
        & (LANES - 1)
    return m.reshape(ng, Tp * 4, 8, LANES)[:, :Tn].reshape(
        ng, SUBLANES, b.nw, b.L, 8, LANES)


def _wl_slots(b: DeviceBinIndex):
    """Slot s of tile ``t = (rb*NW + w)*L + l`` of group g, row rb*128+j,
    gathers ``x[128*slab[g,rb,w,s] + m]``."""
    ng, nw, L = b.n_groups, b.nw, b.L
    slab = b.slab_list.view(ng, SUBLANES, nw, 1, 8, 1).long()
    return ((ng, SUBLANES, nw, L, 8, LANES), slab * LANES + _unpack_wl_ja(b),
            None, (2, 3, 4))


def _chunk_table(b: DeviceBinIndex, per_chunk: int) -> torch.Tensor:
    """The bin's per-chunk table repeated for each of the chunk's entries:
    (ng, 8, K, per_chunk)."""
    nchunks = b.k // b.chunk_k
    return b.slab_list.view(b.n_groups, SUBLANES, nchunks, per_chunk) \
        .repeat_interleave(b.chunk_k, dim=2).long()


def _sb_slots(b: DeviceBinIndex):
    """Entry k of row sb*128+j of group g at plane row ``g*8K + sb*K + k``.
    int32 planes hold the column (both layouts). int16 sb-major planes hold
    ``(dq<<7)|m``: ``col = 128*(qbase+dq) + m``, ``qbase = slab_list[g,
    sb*nchunks + k//chunk_k]``; int16 sb-list planes hold ``(js<<7)|m``:
    ``col = 128*slab_list[g, (sb*nchunks + k//chunk_k)*span + js] + m``. A
    negative dq or js is a pad: it contributes nothing and reads x[0]."""
    shape = (b.n_groups, SUBLANES, b.k, LANES)
    v = b.ja.view(shape).long()
    if b.ja.dtype == torch.int32:
        return shape, v, None, (2,)
    hi, m = v >> 7, v & (LANES - 1)
    if b.layout == "sb-major":
        slab = _chunk_table(b, 1) + hi
    else:
        slab = torch.gather(_chunk_table(b, b.span), 3, hi.clamp(min=0))
    keep = hi >= 0
    return shape, torch.where(keep, slab * LANES + m, 0), keep, (2,)


def _sg_slots(b: DeviceBinIndex):
    """Slot (p, j) of tile t < slab_count[g] holds ``md``; it gathers
    ``x[128*(w0 + (md>>10)) + (md & 127)]``, ``w0 = slab_list[g,
    t*stride]``, and lands on row p*128+j (rows mode). Tiles past
    slab_count are padding and contribute nothing.

    On the GPU the static span V and the dynamic pass counts do not change
    what an entry computes: they only bounded the TPU kernel's masked
    passes over the window, so neither version reads them."""
    ng, T = b.n_groups, b.k
    stride = 2 if b.span == 0 else 1
    shape = (ng, T, SUBLANES, LANES)
    md = b.ja.view(shape).long()
    w0 = b.slab_list.view(ng, T, stride)[:, :, 0].long()
    cols = (w0[:, :, None, None] + (md >> 10)) * LANES + (md & (LANES - 1))
    real = torch.arange(T, device=md.device)[None, :] \
        < b.slab_count.long()[:, None]
    return shape, cols, real[:, :, None, None], (1,)


_SLOTS = {"k-major": _k_major_slots, "wl": _wl_slots, "sb-major": _sb_slots,
         "sb-list": _sb_slots, "sg": _sg_slots}


# ---------------------------------------------------------------------------
# plain PyTorch versions: (n_groups, 8, 128) row sums of one bin
# ---------------------------------------------------------------------------


def _products(b: DeviceSellBin, x_tab: torch.Tensor):
    """f32 product of each slot (0 where it contributes nothing) and the
    axes that sum them into rows."""
    shape, cols, keep, dims = _SLOTS[b.layout](b)
    prod = b.as_.view(shape).float() * x_tab[cols]
    if keep is not None:
        prod = torch.where(keep, prod, 0.0)
    return prod, dims


def _row_sums(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    prod, dims = _products(b, x_tab)
    return prod.sum(dim=dims)


def k_major_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, i, j] = sum_k as[(g*K+k)*8+i, j] * x[ja[(g*K+k)*8+i, j]]``."""
    return _row_sums(b, x_tab)


def wl_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, rb, j] = sum_{w,l,s} as * x[128*slab[g,rb,w,s] + m]`` over the
    tiles ``t = (rb*NW + w)*L + l`` of group g."""
    return _row_sums(b, x_tab)


def sb_major_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, sb, j] = sum_k as * x[col]`` over entries ``g*8K + sb*K + k``
    of lane j, col decoded as :func:`_sb_slots` says (int16 pads skipped)."""
    return _row_sums(b, x_tab)


def sb_list_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """sb-major data layout, sb-list int16 decode (:func:`_sb_slots`)."""
    return _row_sums(b, x_tab)


def sg_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """Each real slot's product ``as * x[col]`` (:func:`_sg_slots`) lands on
    row ``sigma*128 + j`` with ``sigma = (md>>7)&7`` (slots mode) or
    ``sigma = p`` (rows mode)."""
    prod, dims = _products(b, x_tab)
    if not b.sg_slots:
        return prod.sum(dim=dims)
    ng, T = b.n_groups, b.k
    sigma = (b.ja.view(ng, T, SUBLANES, LANES).long() >> 7) & (SUBLANES - 1)
    out = torch.zeros(ng, SUBLANES, LANES, dtype=torch.float32,
                      device=prod.device)
    return out.scatter_add_(1, sigma.view(ng, T * SUBLANES, LANES),
                            prod.view(ng, T * SUBLANES, LANES))


_PLAIN = {"k-major": k_major_bin_plain, "wl": wl_bin_plain,
          "sb-major": sb_major_bin_plain, "sb-list": sb_list_bin_plain,
          "sg": sg_bin_plain}


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch the kernel, CPU tensors run the plain version
# ---------------------------------------------------------------------------


def _check_bin(b: DeviceBinIndex, values: dict, device: torch.device,
               value_types: tuple):
    """Check a bin's own tensors for a launch on ``device`` (x's): there and
    contiguous, int32 tables, the layout's index type, ``value_types``
    values, and matching sizes."""
    tensors = {"group_ids": b.group_ids, "ja": b.ja, "slab_list": b.slab_list,
               "slab_count": b.slab_count, **values}
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name in ("group_ids", "slab_list", "slab_count"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    ja_types = (torch.int32, torch.int16) if b.layout in _SB_LAYOUTS \
        else (torch.int32,)
    if b.ja.dtype not in ja_types:
        raise ValueError(f"{b.layout} index plane must be "
                         f"{' or '.join(map(str, ja_types))}, got {b.ja.dtype}")
    plane = b.n_groups * b.k * SUBLANES * LANES
    for name, t in values.items():
        if t.dtype not in value_types:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(map(str, value_types))}, got "
                             f"{t.dtype}")
        if t.numel() != plane:
            raise ValueError(f"{name} does not match the bin's shape")
    if b.layout != "wl" and b.ja.numel() != plane:
        raise ValueError("index plane does not match the value plane")
    if b.n_groups * SUBLANES > _INT32_MAX:
        raise ValueError("the bin's grid is beyond 32-bit indexing")


def _check_launch(b: DeviceBinIndex, values: dict, xs: dict, ys: dict,
                 value_types: tuple):
    """Check what a kernel launch reads and writes: every tensor on the
    device of the first x and contiguous, the bin's tensors as
    :func:`_check_bin` says, f32 x and y, and matching sizes."""
    x0 = next(iter(xs.values()))
    if x0.device.type != "cuda":
        raise RuntimeError(
            f"SELL kernels run on CUDA or CPU tensors, not {x0.device}")
    for name, t in {**xs, **ys}.items():
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    _check_bin(b, values, x0.device, value_types)
    if any(t.dtype != torch.float32 for t in (*xs.values(), *ys.values())):
        raise ValueError("x and y must be float32")
    if x0.numel() > _INT32_MAX:
        raise ValueError("x is beyond 32-bit indexing")
    y0 = next(iter(ys.values()))
    if y0.numel() % GROUP_ROWS or any(t.numel() != y0.numel()
                                      for t in ys.values()):
        raise ValueError("y must hold whole groups of 1024 rows")


def _check_table(b: DeviceBinIndex, numel: int, what: str):
    if b.slab_list.numel() != numel:
        raise ValueError(f"{b.layout} {what} holds {b.slab_list.numel()} "
                         f"entries, the bin needs {numel}")


def _k_major_call(b):
    return "sell_k_major", "", (b.group_ids, b.ja), (b.n_groups, b.k)


def _wl_call(b):
    Tp = -(-SUBLANES * b.nw * b.L // 4)
    if b.ja.numel() != b.n_groups * Tp * 8 * LANES:
        raise ValueError("wl index plane does not match the bin")
    _check_table(b, b.n_groups * SUBLANES * b.nw * 8, "slab table")
    return ("sell_wl", "", (b.group_ids, b.slab_list, b.ja),
            (b.n_groups, b.nw, b.L))


def _sb_call(b):
    if b.k % b.chunk_k:
        raise ValueError(f"k={b.k} is not a multiple of chunk_k={b.chunk_k}")
    i16 = b.ja.dtype == torch.int16
    if i16:
        per_chunk = b.span if b.layout == "sb-list" else 1
        _check_table(b, b.n_groups * SUBLANES * b.k // b.chunk_k * per_chunk,
                     "chunk table")
    return ("sell_" + b.layout.replace("-", "_"), "_i16" if i16 else "_i32",
            (b.group_ids, b.slab_list, b.ja),
            (b.n_groups, b.k, b.chunk_k, b.span))


def _sg_call(b):
    stride = 2 if b.span == 0 else 1
    _check_table(b, b.n_groups * b.k * stride, "window table")
    if b.slab_count.numel() != b.n_groups:
        raise ValueError("sg tile counts do not match the bin's groups")
    return ("sell_sg", "", (b.group_ids, b.slab_list, b.slab_count, b.ja),
            (b.n_groups, b.k, stride, int(b.sg_slots)))


# layout -> (entry stem, entry suffix, pointer arguments before the value/x/y
# operands, scalar arguments after them), after the layout's own checks
_CALL = {"k-major": _k_major_call, "wl": _wl_call, "sb-major": _sb_call,
         "sb-list": _sb_call, "sg": _sg_call}


def _launch(wrapper, b: DeviceBinIndex, precision: str, operands: tuple,
           accumulate: bool):
    """Call C entry ``<stem>_<precision><suffix>`` for bin ``b`` with its
    layout's arguments around ``operands`` (value planes, x tables, y;
    device pointers), then ``accumulate`` and the current stream; count the
    launch on ``wrapper``."""
    stem, suffix, before, after = _CALL[b.layout](b)
    name = f"{stem}_{precision}{suffix}"
    device = operands[0].device
    with torch.cuda.device(device):
        fn = getattr(_build.load(), name)
        err = fn(*(a.data_ptr() for a in (*before, *operands)), *after,
                 int(accumulate), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    wrapper.accumulating += bool(accumulate)


def _write_plain(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                 accumulate: bool = False):
    rows = y.view(-1, SUBLANES, LANES)
    idx = b.group_ids.long()
    out = _PLAIN[b.layout](b, x_tab)
    rows[idx] = rows[idx] + out if accumulate else out


def _bin(wrapper, b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
         accumulate: bool):
    if x_tab.device.type == "cpu":
        return _write_plain(b, x_tab, y, accumulate)
    _check_launch(b, {"as_": b.as_}, {"x": x_tab}, {"y": y},
                 (torch.float32, torch.bfloat16))
    _launch(wrapper, b, "bf16" if b.as_.dtype == torch.bfloat16 else "f32",
           (b.as_, x_tab, y), accumulate)


def k_major_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + i*128 + j`` of ``y``."""
    _bin(k_major_bin, b, x_tab, y, accumulate)


def wl_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
           accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + rb*128 + j`` of ``y``."""
    _bin(wl_bin, b, x_tab, y, accumulate)


def sb_major_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                 accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + sb*128 + j`` of ``y``."""
    _bin(sb_major_bin, b, x_tab, y, accumulate)


def sb_list_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
                accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + sb*128 + j`` of ``y``."""
    _bin(sb_list_bin, b, x_tab, y, accumulate)


def sg_bin(b: DeviceSellBin, x_tab: torch.Tensor, y: torch.Tensor,
           accumulate: bool = False):
    """Write (or add) bin ``b``'s rows ``gid*1024 + sigma*128 + j`` of ``y``."""
    _bin(sg_bin, b, x_tab, y, accumulate)


_KERNEL = {"k-major": k_major_bin, "wl": wl_bin, "sb-major": sb_major_bin,
           "sb-list": sb_list_bin, "sg": sg_bin}
for _w in _KERNEL.values():
    _w.launches = 0
    _w.accumulating = 0


def _run_kernel(b: DeviceSellBin, x_tab, y, accumulate: bool):
    if b.layout not in _KERNEL:
        raise ValueError(f"unknown SELL bin layout {b.layout!r}")
    _KERNEL[b.layout](b, x_tab, y, accumulate)


def _check_x_table(dsell, x_tab: torch.Tensor):
    n = slab_table_rows(dsell.ncols) * LANES
    if x_tab.dtype != torch.float32 or tuple(x_tab.shape) != (n,):
        raise ValueError(
            f"x must be the padded f32 table of device_put_x / pack_x_table "
            f"({n} entries for {dsell.ncols} columns), got {x_tab.dtype} "
            f"{tuple(x_tab.shape)}")


def _assemble(dsell, xs: tuple, write) -> tuple:
    """One y per x table: the core bins store their own groups' rows, then
    every ``add_into`` bin adds onto them, on one stream; returns each
    ``y[:nrows]``. ``write(b, *xs, *ys, accumulate)`` runs one bin."""
    for x_tab in xs:
        _check_x_table(dsell, x_tab)
    ys = tuple(torch.zeros(dsell.num_groups * GROUP_ROWS, dtype=torch.float32,
                           device=xs[0].device) for _ in xs)
    for accumulate in (False, True):
        for b in dsell.bins:
            if b.add_into == accumulate:
                write(b, *xs, *ys, accumulate)
    return tuple(y[: dsell.nrows] for y in ys)


def _spmv(dsell: DeviceSell, x_tab: torch.Tensor, write) -> torch.Tensor:
    if not isinstance(dsell, DeviceSell):
        raise TypeError(f"sell_spmv takes a DeviceSell, got "
                        f"{type(dsell).__name__} (column panels: "
                        "panel_sell_spmv; dd: sell_spmv_dd)")
    return _assemble(dsell, (x_tab,), write)[0]


def sell_spmv(dsell: DeviceSell, x_tab: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over the binned SELL layout; returns ``y[:nrows]`` (f32).

    ``x_tab`` is x padded by :func:`device_put_x` or :func:`pack_x_table`.
    Core bins store their own groups' rows, then ``add_into`` bins add onto
    them; CUDA tensors run the CUDA kernels, CPU tensors the plain
    versions."""
    return _spmv(dsell, x_tab, _run_kernel)


def sell_spmv_plain(dsell: DeviceSell, x_tab: torch.Tensor) -> torch.Tensor:
    """:func:`sell_spmv` through the plain versions on any device — the
    reference the kernels are held against."""
    return _spmv(dsell, x_tab, _write_plain)


def _assemble_panels(dps, xs: tuple, write) -> tuple:
    """One y per unpadded x vector; each panel packs its own x tables for
    its columns and every bin adds onto the same rows."""
    ys = tuple(torch.zeros(dps.num_groups * GROUP_ROWS, dtype=torch.float32,
                           device=xs[0].device) for _ in xs)
    for p, dsell in enumerate(dps.panels):
        c0, c1 = dps.bounds[p], dps.bounds[p + 1]
        tabs = tuple(pack_x_table(x[c0:c1], c1 - c0) for x in xs)
        for b in dsell.bins:
            write(b, *tabs, *ys, True)
    return tuple(y[: dps.nrows] for y in ys)


def _check_panel_x(dps, x: torch.Tensor):
    if x.dtype != torch.float32 or tuple(x.shape) != (dps.ncols,):
        raise ValueError(f"x must be an f32 vector of {dps.ncols} entries, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _panel_spmv(dps: DevicePanelSell, x: torch.Tensor, write) -> torch.Tensor:
    if not isinstance(dps, DevicePanelSell):
        raise TypeError(f"panel_sell_spmv takes a DevicePanelSell, got "
                        f"{type(dps).__name__}")
    _check_panel_x(dps, x)
    return _assemble_panels(dps, (x,), write)[0]


def panel_sell_spmv(dps: DevicePanelSell, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over column panels (≙ the JAX ``_panel_spmv``): x is the
    unpadded f32 vector on the device; each panel packs its own x table for
    its columns and every bin accumulates onto one y."""
    return _panel_spmv(dps, x, _run_kernel)


def panel_sell_spmv_plain(dps: DevicePanelSell,
                          x: torch.Tensor) -> torch.Tensor:
    """:func:`panel_sell_spmv` through the plain versions."""
    return _panel_spmv(dps, x, _write_plain)
