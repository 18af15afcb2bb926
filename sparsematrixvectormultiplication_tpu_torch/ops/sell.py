"""SELL-C-128 SpMV in PyTorch: upload, per-bin kernels and their plain twins.

Counterpart of the JAX package's ``ops/pallas_sell.py``, one CUDA kernel per
bin layout:

* ``k-major`` (``_kernel_k_major``) -> ``csrc/sell_k_major.cu``; a bin of
  few groups splits each row's slots over lanes (:func:`_k_major_lanes`)
  joined in a fixed order (the dd bins of one lane a row are compacted:
  :func:`_compact_km`, :mod:`.sell_dd`)
* ``wl`` window-layered (``_kernel_wl``) -> ``csrc/sell_wl.cu``, on planes
  the upload compacts (:func:`_compact_wl`: the pad slots are dropped and
  each real slot carries a 2-byte column code)
* ``sb-major`` and ``sb-list`` (``_kernel_sb_major``, ``_kernel_sb_list``),
  int32 or int16 index planes -> ``csrc/sell_sb.cu``; the upload compacts
  sb-list bins with int32 planes (:func:`_compact_sl`: each group's rows
  sorted by length, pad slots dropped, one plane per 32 sorted rows)
* ``sg`` shared-window tiles (``_kernel_sg``), slots or rows mode, static or
  dynamic pass tables -> ``csrc/sell_sg.cu``, on planes the upload compacts
  as it compacts sb-list bins (:func:`_compact_sg`: the empty slots of the
  real tiles dropped, each real slot decoded to its row and column), run by
  the compacted sb-list kernel's code (the dd sg bins stay padded:
  :mod:`.sell_dd`)

Every kernel and every plain version follows one stored-zero rule: a slot
whose value is zero adds nothing to its row (the kernels replace its x by 0
with a select on the value before the multiply; ``csrc/sell_common.cuh``).
On finite x that is the sum of every slot, up to the sign of a zero sum;
where x is not finite, a pad or a stored zero at that column adds no NaN.
The compacted uploads drop exactly those slots.

Each kernel has a wrapper (:func:`k_major_bin`, :func:`wl_bin`,
:func:`sb_major_bin`, :func:`sb_list_bin`, :func:`sg_bin`) and a plain
PyTorch version (``*_bin_plain``) computing the same function: values
widened to f32, x and the sums in f32. The k-major, wl, sb-list and sg plain
versions add the slots in the kernels' order with the kernels' rounding
(:func:`fma_f32`), so the card can hold them bit for bit. A wrapper given
CUDA tensors launches its kernel, or raises; given CPU tensors it runs the
plain version. Each wrapper counts its kernel launches in ``.launches``,
those made with ``accumulate=True`` (the bin's sums added onto y
instead of stored) also in ``.accumulating``, and those of its bf16 entry
also in ``.launches_bf16``.

:func:`sell_spmv` runs a :class:`DeviceSell` by its launch plan
(:class:`LaunchPlan`, built at upload): the bins that share a kernel and
every scalar of its launch go out as one launch of a joint bin, whose index
and value planes are one allocation of which each member's planes are views,
its members' blocks in order of their groups, fewest first. The core joint
launches store their rows, then the ``add_into`` ones (the sg far remainder)
accumulate onto them, on the same stream — the JAX "auto" assembly. y is
zero-filled only where the core bins do not write every group.
:func:`panel_sell_spmv` runs a :class:`DevicePanelSell` (column panels)
whose bins' columns were rebased onto the whole x at upload: x is packed
once, the panels' bins join by the same rule, each panel's core bins write
one slice of a scratch y and each ``add_into`` bin one of its own, and
:func:`panel_reduce` (``csrc/panel_reduce.cu``) adds the slices into y in
the order of the panel-by-panel accumulation.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.sell import CHUNK_K, GROUP_ROWS, LANES, SUBLANES, slab_table_rows
from ..utils.profiling import annotate
from . import _build
from .doubledouble import dd_add_dd

__all__ = [
    "DeviceBinIndex", "DeviceSellBin", "DeviceSell", "DevicePanelSell",
    "device_put_sell", "device_put_x", "pack_x_table", "k_major_bin",
    "wl_bin", "sb_major_bin", "sb_list_bin", "sg_bin", "k_major_bin_plain",
    "wl_bin_plain", "sb_major_bin_plain", "sb_list_bin_plain", "sg_bin_plain",
    "sell_spmv", "sell_spmv_plain", "sell_spmv_launches", "panel_sell_spmv",
    "panel_sell_spmv_plain", "Joint", "LaunchPlan", "PanelPlan",
    "panel_x_table", "panel_reduce", "panel_reduce_plain", "plan_bytes",
    "RowMap", "row_gather", "row_gather_plain", "row_gather_dd",
    "row_gather_dd_plain",
]

_INT32_MAX = 2**31 - 1
_SB_LAYOUTS = ("sb-major", "sb-list")
_SB_I16_MAX_SPAN = 255  # the int16 planes hold dq or js in 8 bits
_WARP = 32      # compacted sb-list: sorted rows that share one plane
_ROW_BITS = 10  # compacted sb-list row table: (length << 10) | row in group
# the k-major SpMM kernel stages a block's x window in shared memory when it
# spans at most this many x rows (64 KB at R = 32)
_STAGE_ROWS = 512


@dataclass(kw_only=True)
class DeviceBinIndex:
    """The index side of one rectangular bin on a device, shared by the f32
    bins here and the double-double bins of :mod:`.sell_dd`.

    Every layout's value plane is ``(n_groups*k*8, 128)``.

    * ``k-major``: ``ja`` holds absolute columns; entry e of row i*128+j of
      group g at row ``(g*k + e)*8 + i``. ``slab_list`` is not read. A dd
      bin of one lane a row is compacted (:func:`_compact_km`) into the
      compacted sb-list layout below, a row's slots in e order.
    * ``sb-major`` / ``sb-list``: entry e of row sb*128+j at row
      ``g*8k + sb*k + e``, in chunks of ``chunk_k`` entries. ``ja`` holds
      absolute columns (int32, sb-major) or the int16 planes of
      :func:`_pack_sb_i16` / :func:`_pack_sl_i16`. ``slab_list`` is the
      per-chunk qbase table ``(n_groups, 8*k/chunk_k)`` (sb-major) or the
      per-chunk distinct-slab lists ``(n_groups, 8*k/chunk_k*span)``.
    * ``sb-list`` with int32 planes, compacted (:func:`_compact_sl`): each
      group's rows sorted by their real length, longest first, ties in row
      order; sorted row ``s = g*1024 + rank``. The 32 sorted rows of warp
      ``w = s // 32`` own plane rows ``plane_off[w] .. plane_off[w+1]``, as
      many as the longest of them has real slots; slot q of sorted row s
      sits at plane row ``plane_off[w] + q``, lane ``s % 32``, and ``ja``
      (int32, ``(plane_rows, 32)``) holds its column. ``row_table[s] =
      (length << 10) | r``, r the row's index within its group. The value
      planes are ``(plane_rows, 32)``; ``slab_list`` is empty.
    * ``wl``: ``k = 8*nw*L`` slots a row on the host, ``nw = chunk_k``
      windows and ``L = span`` layer tiles; on the device only the real
      slots (:func:`_compact_wl`): block ``b = g*8 + rb`` owns plane rows
      ``plane_off[b] .. plane_off[b+1]``, row ``rb*128 + j``'s slot ``q <
      row_len[b*128 + j]`` sits at plane row ``plane_off[b] + q``, lane
      j, and ``ja`` (int16, ``(plane_rows, 128)``) holds its code ``((w*8 +
      s) << 7) | m`` for column ``128*slab_list[b*nw*8 + (code >> 7)] +
      (code & 127)``; ``slab_list`` the ``(n_groups, 8*nw*8)`` window slab
      ids. The value planes are ``(plane_rows, 128)``.
    * ``sg``: ``k`` tiles per group; ``ja`` holds ``md``; ``slab_list`` the
      ``(n_groups, k*stride)`` window bases (stride 2 when ``span == 0``:
      dynamic bins also carry pass counts); ``slab_count`` the real tiles.
      That is the dd bins' layout. An f32 or bf16 sg bin is compacted
      (:func:`_compact_sg`) into the compacted sb-list layout above: each
      real slot's row (``sigma*128 + j``, or ``p*128 + j`` in rows mode)
      and absolute column, a row's slots in (tile, p) order; ``k``,
      ``span``, ``sg_slots`` and ``slab_count`` stay the host bin's, and
      ``slab_list`` is empty.
    """

    layout: str
    k: int
    n_groups: int
    group_ids: torch.Tensor   # (n_groups,) int32
    ja: torch.Tensor          # int32 | int16 (sb layouts, wl)
    slab_list: torch.Tensor   # int32, layout's table (see above)
    slab_count: torch.Tensor  # (n_groups,) int32
    span: int = 0
    chunk_k: int = CHUNK_K
    add_into: bool = False    # accumulates onto rows another bin wrote
    sg_slots: bool = False    # sg: destination row from md's sigma bits
    row_len: torch.Tensor | None = None    # wl: (n_groups*1024,) int32
    # wl: (n_groups*8 + 1,) int32; compacted sb-list, sg: (n_groups*32 + 1,)
    plane_off: torch.Tensor | None = None
    # compacted sb-list, f32/bf16 sg and dd k-major of one lane a row:
    # (n_groups*1024,) int32
    row_table: torch.Tensor | None = None
    # a joint bin (:class:`Joint`): its members' k-major lanes a row and
    # padded sg chunks a group (0: the functions of the bin's own shape,
    # :func:`_k_major_lanes` and :func:`_sg_chunks`)
    lanes: int = 0
    chunks: int = 0

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
    """One rectangular bin on a device with f32 or bf16 values.

    A k-major bin also carries the SpMM kernel's x windows
    (:func:`_x_window`): ``x_window[g*8 + i] = (first column, span)`` of
    the columns that block (g, i)'s slots name, and ``window_rows``, the
    widest span of at most ``_STAGE_ROWS`` columns (0 when none is), the x
    rows of shared memory its launches reserve."""

    as_: torch.Tensor         # (n_groups*k*8 | plane_rows, 128 | 32) f32|bf16
    x_window: torch.Tensor | None = None  # k-major: (n_groups*8, 2) int32
    window_rows: int = 0


@dataclass
class DeviceSell:
    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bins: list
    # rows in SELL-C-sigma order (the host SELL's ``row_perm``): y comes back
    # permuted, as the harness's sell_sigma stage expects
    sigma_sorted: bool = False
    plan: "LaunchPlan | None" = None  # built at upload (device_put_sell)
    # rows split and sorted by the port's row-order rule (the host SELL's
    # ``row_map``, formats/sell_order.py): y comes back through it
    # (:func:`row_gather`) in the caller's order, ``nrows`` the caller's rows
    row_map: "RowMap | None" = None


@dataclass
class RowMap:
    """Where each caller row's sums sit in a sorted SELL's y: row r is the
    sum, in order, of ``y[pos[ptr[r]:ptr[r+1]]]`` (its segments), 0 where it
    has none. int32 ``ptr`` (nrows + 1) and ``pos``, every ``pos`` below
    ``src_rows``, the sorted y's entries."""

    ptr: torch.Tensor
    pos: torch.Tensor
    src_rows: int = 0


def _row_map(row_map, src_rows: int, device) -> RowMap:
    """The host SELL's ``(ptr, pos)`` checked (ptr from 0, non-decreasing,
    to ``pos.size``; every pos in ``[0, src_rows)``) and uploaded."""
    ptr, pos = (np.asarray(a, np.int64) for a in row_map)
    if ptr.size == 0 or ptr[0] != 0 or np.any(np.diff(ptr) < 0) \
            or ptr[-1] != pos.size or (pos.size and (
                pos.min() < 0 or pos.max() >= src_rows)):
        raise ValueError("the row map's segments do not fit its SELL")
    return RowMap(*(torch.from_numpy(a.astype(np.int32)).to(device)
                    for a in (ptr, pos)), src_rows)


@dataclass
class DevicePanelSell:
    """Column panels on a device: panel p covers columns
    ``[bounds[p], bounds[p+1])`` and holds its own :class:`DeviceSell`,
    whose bins' columns are rebased onto the whole x (:func:`_rebase`):
    every panel reads one x table of ``x_rows`` entries
    (:func:`panel_x_table`)."""

    nrows: int
    ncols: int
    nnz: int
    num_groups: int
    bounds: tuple
    panels: list
    sigma_sorted: bool = False
    x_rows: int = 0
    plan: "PanelPlan | None" = None  # built at upload


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
    (sb planes int16 with ``sb_i16`` where the span fits). A wl bin's ``ja``
    is still its padded lane-index plane (uint8): :func:`_compact_wl` turns
    it into codes together with the values."""
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
        ja = ja.astype(np.uint8)  # lane indices 0..127
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
        ja=_ints(ja, device, ja.dtype if ja.dtype in (np.int16, np.uint8)
                 else np.int32),
        slab_list=_ints(table.reshape(-1), device),
        slab_count=_ints(np.asarray(b.slab_count).reshape(-1), device),
        span=span, chunk_k=ck, add_into=bool(getattr(b, "add_into", False)),
        sg_slots=bool(getattr(b, "sg_slots", False)))


def _compact_wl(index: dict, planes: list) -> tuple:
    """Drop the pad slots of a wl bin, on the bin's device, with torch ops.

    ``index`` holds the bin's fields from :func:`_put_bin_index` (``ja`` the
    padded lane-index plane) and ``planes`` its padded value planes (f32 or
    bf16, or the dd hi and lo planes). A slot is kept when its value is not
    zero in some plane: that drops the pads and any stored zero, the slots
    the stored-zero rule skips anyway. Each
    (group, row-block) gets a plane as wide as its longest row, and a row's
    real slots keep the order (w, l, s) in which the kernel adds them.
    Returns the index fields, with ``ja`` the int16 codes ``((w*8 + s) << 7)
    | m``, ``row_len`` and ``plane_off`` (see :class:`DeviceBinIndex`), and
    the compacted planes; the padded ones are not kept."""
    ng, nw, L, k = (index[f] for f in ("n_groups", "chunk_k", "span", "k"))
    dev = index["ja"].device

    def by_row(t):  # (rows g*1024 + rb*128 + j, the k slots in (w, l, s))
        return t.view(ng, SUBLANES, nw, L, 8, LANES).permute(
            0, 1, 5, 2, 3, 4).reshape(ng * GROUP_ROWS, k)

    keep = by_row(planes[0] != 0)
    for p in planes[1:]:
        keep |= by_row(p != 0)
    row_len = keep.sum(1, dtype=torch.int32)
    plane_off = torch.zeros(ng * SUBLANES + 1, dtype=torch.int32, device=dev)
    plane_off[1:] = torch.cumsum(row_len.view(-1, LANES).amax(1), 0,
                                 dtype=torch.int32)
    rows = int(plane_off[-1])
    r, slot = keep.nonzero(as_tuple=True)
    rank = keep.cumsum(1, dtype=torch.int32)[r, slot] - 1
    dest = (plane_off[r // LANES].long() + rank) * LANES + r % LANES
    del keep
    code = (((slot // (8 * L) * 8 + slot % 8) << 7)
            | by_row(index["ja"])[r, slot].long())

    def scatter(src):
        out = torch.zeros(rows * LANES, dtype=src.dtype, device=dev)
        out[dest] = src
        return out.view(rows, LANES)

    index = {**index, "ja": scatter(code.to(torch.int16)),
             "row_len": row_len, "plane_off": plane_off}
    return index, [scatter(by_row(p)[r, slot]) for p in planes]


def _sl_compacts(index: dict) -> bool:
    """Whether :func:`_compact_sl` takes the bin: sb-list with int32
    planes (int16 planes decode a slot by its chunk, which the compaction
    does not keep, so they stay padded)."""
    return index["layout"] == "sb-list" and index["ja"].dtype == torch.int32


def _row_lists(index: dict, length: torch.Tensor, r: torch.Tensor,
               q: torch.Tensor, cols: torch.Tensor, srcs: list,
               window: int = GROUP_ROWS) -> tuple:
    """The compacted row-list planes of sb-list, sg and dd k-major bins, on
    the bin's device: ``length`` ``(n_groups, 1024)`` holds each row's real
    slots, and real slot i is slot ``q[i]`` of row ``r[i]`` (``g*1024 +
    row``), its absolute column ``cols[i]`` and its values ``srcs`` (one
    tensor a plane). The rows of each ``window`` rows of a group (the whole
    group by default) are sorted by their length, longest first, in a
    stable order, and each 32 sorted rows get a plane as wide as the longest
    of them. Returns the index fields, with ``ja`` the columns,
    ``row_table`` and ``plane_off`` (see :class:`DeviceBinIndex`) and an
    empty ``slab_list``, and the value planes."""
    ng = index["n_groups"]
    dev = length.device
    lens, local = torch.sort(length.view(ng, -1, window), dim=2,
                             descending=True, stable=True)
    lens = lens.view(ng, GROUP_ROWS)
    local = (local + torch.arange(0, GROUP_ROWS, window, device=dev)[
        :, None]).view(ng, GROUP_ROWS)
    plane_off = torch.zeros(ng * GROUP_ROWS // _WARP + 1, dtype=torch.int32,
                            device=dev)
    plane_off[1:] = torch.cumsum(lens.view(-1, _WARP).amax(1), 0,
                                 dtype=torch.int32)
    rows = int(plane_off[-1])
    rank = torch.empty_like(local)
    rank.scatter_(1, local, torch.arange(GROUP_ROWS, device=dev).expand(
        ng, GROUP_ROWS))
    sorted_of = (rank + torch.arange(ng, device=dev)[:, None] * GROUP_ROWS
                 ).view(-1)  # row g*1024 + r -> its sorted row
    s = sorted_of[r]
    dest = (plane_off[s // _WARP].long() + q) * _WARP + s % _WARP

    def scatter(src):
        out = torch.zeros(rows * _WARP, dtype=src.dtype, device=dev)
        out[dest] = src
        return out.view(rows, _WARP)

    row_table = ((lens.long() << _ROW_BITS) | local).view(-1).to(torch.int32)
    index = {**index, "ja": scatter(cols.to(torch.int32)),
             "slab_list": torch.zeros(0, dtype=torch.int32, device=dev),
             "row_table": row_table, "plane_off": plane_off}
    return index, [scatter(v) for v in srcs]


def _compact_rows(index: dict, planes: list, by_row,
                  window: int = GROUP_ROWS) -> tuple:
    """Drop the pad slots of a padded bin, on the bin's device, with torch
    ops: ``by_row`` lays a plane out as ``(n_groups*1024, k)``, row ``g*1024
    + r``'s slots in the order its padded kernel adds them. A slot is kept
    when its value is not zero in some plane, as :func:`_compact_wl` keeps
    it; a row's real slots keep their order, laid out by :func:`_row_lists`
    (rows sorted within ``window`` rows). The padded planes are not
    kept."""
    keep = by_row(planes[0] != 0)
    for p in planes[1:]:
        keep |= by_row(p != 0)
    length = keep.sum(1, dtype=torch.int32).view(index["n_groups"],
                                                 GROUP_ROWS)
    r, slot = keep.nonzero(as_tuple=True)
    q = keep.cumsum(1, dtype=torch.int32)[r, slot] - 1
    del keep
    return _row_lists(index, length, r, q, by_row(index["ja"])[r, slot],
                      [by_row(p)[r, slot] for p in planes], window)


def _compact_sl(index: dict, planes: list) -> tuple:
    """Drop the pad slots of an sb-list bin with int32 planes
    (:func:`_compact_rows`): ``index`` holds the bin's fields from
    :func:`_put_bin_index` and ``planes`` its padded value planes (f32 or
    bf16, or the dd hi and lo planes); a row's slots in entry order."""
    ng, k = index["n_groups"], index["k"]

    def by_row(t):  # (rows g*1024 + sb*128 + j, the k slots in entry order)
        return t.view(ng, SUBLANES, k, LANES).transpose(2, 3).reshape(
            ng * GROUP_ROWS, k)

    return _compact_rows(index, planes, by_row)


def _compact_km(index: dict, planes: list) -> tuple:
    """Drop the pad slots of a k-major bin (:func:`_compact_rows`), the dd
    bins of one lane a row (:mod:`.sell_dd`): entry k of row i*128 + j of
    group g sits at plane row ``(g*K + k)*8 + i``, lane j, and a row's slots
    keep k order, the order in which the padded kernel adds them. Rows are
    sorted by length within their 128-row block, so that each 128-thread
    block of the kernel runs the rows the padded kernel's block ran, whose
    x gathers and y stores lie near each other (on an H100 1-7% faster than
    a sort over the whole group on band64's bin, by kernel variant:
    ``bench/kmajor_dd_sweep.py``)."""
    ng, k = index["n_groups"], index["k"]

    def by_row(t):  # (rows g*1024 + i*128 + j, the k slots in k order)
        return t.view(ng, k, SUBLANES, LANES).permute(0, 2, 3, 1).reshape(
            ng * GROUP_ROWS, k)

    return _compact_rows(index, planes, by_row, LANES)


def _compact_sg(index: dict, planes: list) -> tuple:
    """Drop the empty slots of an sg bin's real tiles, on the bin's device,
    with torch ops.

    ``index`` holds the bin's fields from :func:`_put_bin_index` (``ja`` the
    ``md`` plane) and ``planes`` its padded value planes (f32 or bf16). A
    slot is real when its tile is one of its group's ``slab_count`` real
    tiles and its value is not zero; its row is ``sigma*128 + j``, ``sigma
    = (md >> 7) & 7`` (slots mode), or ``p*128 + j`` (rows mode), and its
    column ``(w0 + (md >> 10))*128 + (md & 127)`` (:func:`_sg_slots`). A
    row's real slots keep their (tile, p) order, laid out by
    :func:`_row_lists`, so the row-list kernel of the compacted sb-list bins
    runs them. The padded planes are not kept."""
    ng, T = index["n_groups"], index["k"]
    dev = index["ja"].device
    stride = 2 if index["span"] == 0 else 1
    shape = (ng, T, SUBLANES, LANES)
    real = torch.arange(T, device=dev)[None, :] \
        < index["slab_count"].long()[:, None]
    keep = planes[0].view(shape) != 0
    for other in planes[1:]:
        keep |= other.view(shape) != 0
    keep &= real[:, :, None, None]
    g, t, p, j = keep.nonzero(as_tuple=True)  # in (g, t, p, j) order
    del keep, real
    md = index["ja"].view(shape)[g, t, p, j].long()
    w0 = index["slab_list"].view(ng, T, stride)[g, t, 0].long()
    cols = (w0 + (md >> 10)) * LANES + (md & (LANES - 1))
    row = ((md >> 7) & (SUBLANES - 1) if index["sg_slots"] else p) * LANES + j
    # a row's slots, stably sorted by row, stay in (t, p) order
    r, order = torch.sort(g * GROUP_ROWS + row, stable=True)
    del md, w0, row
    length = torch.bincount(r, minlength=ng * GROUP_ROWS)
    start = torch.cumsum(length, 0) - length
    q = torch.arange(r.numel(), device=dev) - start[r]
    return _row_lists(index, length.view(ng, GROUP_ROWS).to(torch.int32), r,
                      q, cols[order],
                      [pl.view(shape)[g, t, p, j][order] for pl in planes])


def _x_window(index: dict) -> dict:
    """The k-major SpMM kernel's window table of a k-major bin: for block
    (g, i) the first column its slots name, pads included, and the span to
    the last, ``(n_groups*8, 2)`` int32; and ``window_rows``, the widest
    span of at most ``_STAGE_ROWS`` columns (0 when none is)."""
    ng, k = index["n_groups"], index["k"]
    ja = index["ja"].view(ng, k, SUBLANES, LANES)
    if ja.numel() == 0:
        win = torch.zeros(ng * SUBLANES, 2, dtype=torch.int32,
                          device=ja.device)
    else:
        lo, hi = ja.amin(dim=(1, 3)), ja.amax(dim=(1, 3))
        win = torch.stack([lo, hi - lo + 1], -1).view(-1, 2).to(torch.int32)
    span = win[:, 1]
    fits = span[span <= _STAGE_ROWS]
    return {"x_window": win.contiguous(),
            "window_rows": int(fits.max()) if fits.numel() else 0}


def _on(device: torch.device, put):
    """``put(d)`` builds a bin on device ``d``. A meta device holds no
    values to compact, so the bin is built on the host and moved there."""
    if device.type != "meta":
        return put(device)
    b = put(torch.device("cpu"))
    return dataclasses.replace(b, **{
        f.name: getattr(b, f.name).to(device) for f in dataclasses.fields(b)
        if isinstance(getattr(b, f.name), torch.Tensor)})


def _rebase(index: dict, c0: int) -> dict:
    """Bin index fields of a column panel starting at column ``c0`` (a
    multiple of 128) rebased onto the whole x, in new tensors (a CPU upload
    shares the host bin's arrays): absolute int32 columns gain ``c0``,
    slab ids (wl slab lists, sb chunk tables, sg window bases) ``c0 /
    128``, a k-major bin's x windows ``c0``. A pad slot's read moves with
    its panel's spare slab, still inside the whole table
    (:func:`_panel_x_rows`), and the stored-zero rule keeps its x out."""
    if c0 == 0:
        return index
    if c0 % LANES:
        raise ValueError(f"panel start {c0} is not a multiple of {LANES}")
    ja, table = index["ja"], index["slab_list"]
    tiles = index["layout"] == "sg" and index.get("row_table") is None
    if tiles:  # padded sg: (window base, passes) or window base a tile
        stride = 2 if index["span"] == 0 else 1
        table = table + torch.tensor([c0 // LANES, 0][:stride],
                                     dtype=table.dtype, device=table.device
                                     ).repeat(table.numel() // stride)
    elif index["layout"] != "k-major":  # slab ids (empty when compacted)
        table = table + c0 // LANES
    if ja.dtype == torch.int32 and not tiles:  # absolute columns
        ja = ja + c0
    index = {**index, "ja": ja, "slab_list": table}
    if index.get("x_window") is not None:
        index["x_window"] = index["x_window"] + torch.tensor(
            [c0, 0], dtype=torch.int32, device=table.device)
    return index


def _put_bin(b, dtype, device, sb_i16: bool, col0: int = 0) -> DeviceSellBin:
    def put(dev):
        index = _put_bin_index(b, dev, sb_i16)
        vals = _values(b.as_, dtype, dev)
        if b.layout == "wl":
            index, (vals,) = _compact_wl(index, [vals])
        elif _sl_compacts(index):
            index, (vals,) = _compact_sl(index, [vals])
        elif b.layout == "sg":
            index, (vals,) = _compact_sg(index, [vals])
        window = _x_window(index) if b.layout == "k-major" else {}
        return DeviceSellBin(**_rebase({**index, **window}, col0), as_=vals)
    return _on(device, put)


def _panel_x_rows(bounds: tuple, ncols: int) -> int:
    """Entries of the whole x table that rebased column panels read: the
    flat table's, or more where a panel's spare slab, rebased, lies past
    it (a panel whose start is not a multiple of 1024 columns)."""
    slabs = max([slab_table_rows(ncols)] + [
        c0 // LANES + slab_table_rows(c1 - c0)
        for c0, c1 in zip(bounds[:-1], bounds[1:])])
    return slabs * LANES


def device_put_sell(sell, dtype=torch.float32, *, device, sb_i16=False):
    """Upload a host SELL matrix to ``device``.

    ``sell`` is this package's :class:`~..formats.sell.SellMatrix` or
    :class:`~..formats.sell.PanelSellMatrix` (returns a
    :class:`DevicePanelSell`, its bins' columns rebased onto the whole x),
    or the JAX package's host counterparts: only bin attributes are read.
    wl bins are compacted on the device (:func:`_compact_wl`), and so are
    sb-list bins with int32 planes (:func:`_compact_sl`) and sg bins
    (:func:`_compact_sg`): their pad slots, and any stored zero, are
    dropped, which the stored-zero rule makes the same function.
    ``sb_i16=True`` stores sb-major and sb-list index planes as int16 (as
    the JAX package's ``SPMV_SB_I16=1`` does) for bins whose span fits 8
    bits; those sb-list bins stay padded, and other bins keep int32
    columns. k-major bins carry the SpMM kernel's window table
    (:func:`_x_window`). The launch plan (:func:`_flat_plan`,
    :func:`_panel_plan`) is built last: each joint bin's planes are
    allocated once and its members' copied in, plane by plane, each
    member's own plane freed as it becomes a view."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value dtype {dtype} not supported "
                         "(torch.float32 or torch.bfloat16)")
    return _put(sell, device, lambda b, dev, c0: _put_bin(b, dtype, dev,
                                                         sb_i16, c0),
                DeviceSell, DevicePanelSell)


def _put(sell, device, put_bin, flat, panelled):
    """Upload ``sell`` with ``put_bin(host bin, device, col0)`` into a
    ``flat`` (:class:`DeviceSell`-like) or ``panelled`` object, and build
    its launch plan."""
    device = torch.device(device)
    row_map = getattr(sell, "row_map", None)
    sigma = getattr(sell, "row_perm", None) is not None and row_map is None
    if hasattr(sell, "panels"):
        bounds = tuple(int(c) for c in sell.bounds)
        panels = [flat(int(p.nrows), int(p.ncols), int(p.nnz),
                       int(p.num_groups),
                       [put_bin(b, device, bounds[i]) for b in p.bins])
                  for i, p in enumerate(sell.panels)]
        d = panelled(int(sell.nrows), int(sell.ncols), int(sell.nnz),
                     int(sell.num_groups), bounds, panels, sigma,
                     x_rows=_panel_x_rows(bounds, int(sell.ncols)))
        if device.type != "meta":
            d.plan = _panel_plan(d)
        return d
    nrows = int(sell.nrows) if row_map is None else len(row_map[0]) - 1
    d = flat(nrows, int(sell.ncols), int(sell.nnz), int(sell.num_groups),
             [put_bin(b, device, 0) for b in sell.bins], sigma)
    if row_map is not None:
        d.row_map = _row_map(row_map, int(sell.num_groups) * GROUP_ROWS,
                             device)
    if device.type != "meta":
        d.plan = _flat_plan(d.bins)
    return d


def _x_table(x: torch.Tensor, n: int) -> torch.Tensor:
    tab = torch.zeros(n, dtype=torch.float32, device=x.device)
    tab[: x.shape[0]] = x
    return tab


def pack_x_table(x: torch.Tensor, ncols: int) -> torch.Tensor:
    """x as f32, zero-padded to ``slab_table_rows(ncols)*128`` entries: pad
    slots gather from the spare all-zero slab past the last column."""
    return _x_table(x, slab_table_rows(ncols) * LANES)


def device_put_x(x, ncols: int, *, device) -> torch.Tensor:
    """Upload a host vector pre-padded as :func:`pack_x_table` lays it out."""
    return pack_x_table(torch.as_tensor(np.asarray(x)), ncols).to(device)


# ---------------------------------------------------------------------------
# column decode: each slot's plane position and x index, shared by the plain
# f32 versions here and the plain dd versions of .sell_dd
# ---------------------------------------------------------------------------


def _k_major_slots(b: DeviceBinIndex):
    """Entry k of row i*128+j of group g at plane row ``(g*K + k)*8 + i``
    gathers ``x[ja]``; a compacted bin (:func:`_compact_km`) decodes as a
    compacted sb-list bin (:func:`_list_slots`)."""
    if b.row_table is not None:
        return _list_slots(b)
    shape = (b.n_groups, b.k, SUBLANES, LANES)
    return shape, b.ja.view(shape).long(), None, (1,)


def _wl_slots(b: DeviceBinIndex):
    """Slot (r, j) of the compacted planes (:class:`DeviceBinIndex`): its
    column ``128*slab_list[blk*nw*8 + (code >> 7)] + (code & 127)``, ``blk``
    the block whose plane holds row r, and whether it is a real slot (within
    its row's ``row_len``). No axes sum the planes into rows: the plain
    versions walk each row's slots (:func:`_wl_steps`)."""
    widths = (b.plane_off[1:] - b.plane_off[:-1]).long()
    blk = torch.repeat_interleave(
        torch.arange(widths.numel(), device=b.ja.device), widths)
    code = b.ja.long()
    slab = b.slab_list.view(-1, b.nw * 8).long()[blk[:, None], code >> 7]
    q = torch.arange(blk.numel(), device=blk.device) - b.plane_off.long()[blk]
    keep = q[:, None] < b.row_len.view(-1, LANES).long()[blk]
    return (tuple(b.ja.shape), slab * LANES + (code & (LANES - 1)), keep,
            None)


def _wl_steps(b: DeviceBinIndex):
    """Each step q of the wl kernel's row loops: the plane position of every
    row's q-th slot (0 where the row has none), its column (0 where the row
    has none: a raw X holds no spare slab), and whether the row has one;
    rows ``g*1024 + rb*128 + j``."""
    n_rows = b.n_groups * GROUP_ROWS
    if n_rows == 0:
        return
    r = torch.arange(n_rows, device=b.ja.device)
    blk = r // LANES
    base = b.plane_off.long()[blk] * LANES + r % LANES
    slab_x = b.slab_list.view(-1, b.nw * 8).long() * LANES
    n = b.row_len.long()
    codes = b.ja.view(-1)
    for q in range(int(n.max())):
        has = q < n
        pos = torch.where(has, base + q * LANES, 0)
        code = codes[pos].long()
        col = slab_x[blk, code >> 7] + (code & (LANES - 1))
        yield pos, torch.where(has, col, 0), has


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
    slab_count are padding and contribute nothing. A compacted bin
    (:func:`_compact_sg`) decodes as a compacted sb-list bin
    (:func:`_list_slots`).

    On the GPU the static span V and the dynamic pass counts do not change
    what an entry computes: they only bounded the TPU kernel's masked
    passes over the window, so neither version reads them."""
    if b.row_table is not None:
        return _list_slots(b)
    ng, T = b.n_groups, b.k
    stride = 2 if b.span == 0 else 1
    shape = (ng, T, SUBLANES, LANES)
    md = b.ja.view(shape).long()
    w0 = b.slab_list.view(ng, T, stride)[:, :, 0].long()
    cols = (w0[:, :, None, None] + (md >> 10)) * LANES + (md & (LANES - 1))
    real = torch.arange(T, device=md.device)[None, :] \
        < b.slab_count.long()[:, None]
    return shape, cols, real[:, :, None, None], (1,)


def _sl_slots(b: DeviceBinIndex):
    """sb-list: the padded layout's slots (:func:`_sb_slots`), or a
    compacted bin's (:func:`_list_slots`)."""
    if b.row_table is None:
        return _sb_slots(b)
    return _list_slots(b)


def _list_slots(b: DeviceBinIndex):
    """Slot (r, l) of a compacted bin's planes (sb-list, sg, k-major): its
    column ``ja[r, l]`` and whether it is a real slot (within its sorted
    row's length). No axes sum the compacted planes into rows: the plain
    versions walk each row's slots (:func:`_list_steps`)."""
    widths = (b.plane_off[1:] - b.plane_off[:-1]).long()
    warp = torch.repeat_interleave(
        torch.arange(widths.numel(), device=b.ja.device), widths)
    q = torch.arange(warp.numel(), device=warp.device) \
        - b.plane_off.long()[warp]
    length = (b.row_table >> _ROW_BITS).view(-1, _WARP).long()
    return tuple(b.ja.shape), b.ja.long(), q[:, None] < length[warp], None


def _list_steps(b: DeviceBinIndex):
    """Each step q of the row-list kernel's row loops: the plane
    position of every sorted row's q-th slot (0 where the row has none) and
    whether the row has one; sorted rows ``s = g*1024 + rank``."""
    n_rows = b.n_groups * GROUP_ROWS
    if n_rows == 0:
        return
    s = torch.arange(n_rows, device=b.ja.device)
    base = b.plane_off.long()[s // _WARP] * _WARP + s % _WARP
    n = (b.row_table >> _ROW_BITS).long()
    for q in range(int(n.max())):
        has = q < n
        yield torch.where(has, base + q * _WARP, 0), has


def _unsort(b: DeviceBinIndex, t: torch.Tensor) -> torch.Tensor:
    """Sums ``t`` of a compacted bin's sorted rows, ``(n_groups * 1024,)``,
    in row order: ``(n_groups, 8, 128)``."""
    g = torch.arange(t.numel(), device=t.device) // GROUP_ROWS
    out = torch.empty_like(t)
    out[g * GROUP_ROWS + (b.row_table & (GROUP_ROWS - 1)).long()] = t
    return out.view(b.n_groups, SUBLANES, LANES)


_SLOTS = {"k-major": _k_major_slots, "wl": _wl_slots, "sb-major": _sb_slots,
         "sb-list": _sl_slots, "sg": _sg_slots}


# ---------------------------------------------------------------------------
# plain PyTorch versions: (n_groups, 8, 128) row sums of one bin
# ---------------------------------------------------------------------------


def fma_f32(p: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, acc)`` from the exact f64 product ``p = a*b`` of two f32
    values: ``p + acc`` rounded once to f32, as the kernels' fused
    multiply-add rounds it. The f64 sum is made round-to-odd (an inexact sum
    whose last bit is even moves one f64 ulp toward the exact sum), and a
    round-to-odd result of 53 >= 24 + 2 bits rounds to f32 as the exact sum
    would (Boldo and Melquiond). Sums that are not finite are left as
    they are."""
    c = acc.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    odd = torch.where((e != 0) & torch.isfinite(e)
                      & ((s.view(torch.int64) & 1) == 0),
                      torch.nextafter(s, e * math.inf), s)
    return odd.float()


def _live(vals: torch.Tensor, keep) -> torch.Tensor:
    """The slots that add to their row: a value that is not zero (the
    stored-zero rule) in a slot the layout does not mask (``keep``)."""
    nonzero = vals != 0
    return nonzero if keep is None else keep & nonzero


def _products(b: DeviceSellBin, x_tab: torch.Tensor):
    """f32 product of each slot (0 where it contributes nothing: a masked
    slot, or a zero value, whatever x holds) and the axes that sum them into
    rows."""
    shape, cols, keep, dims = _SLOTS[b.layout](b)
    vals = b.as_.view(shape)
    prod = torch.where(_live(vals, keep), vals.float() * x_tab[cols], 0.0)
    return prod, dims


def _row_sums(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    prod, dims = _products(b, x_tab)
    return prod.sum(dim=dims)


def _in_order(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """A padded bin's row sums in its kernel's order: each row's slots along
    the layout's entry axis (:data:`_SLOTS`), ``acc = fmaf(v, x[col], acc)``
    from 0 (:func:`fma_f32`), masked slots and zero values skipped."""
    shape, cols, keep, (axis,) = _SLOTS[b.layout](b)
    vals = b.as_.view(shape)
    live = _live(vals, keep)
    acc = torch.zeros(shape[:axis] + shape[axis + 1:], dtype=torch.float32,
                      device=x_tab.device)
    for e in range(shape[axis]):
        new = fma_f32(vals.select(axis, e).double()
                      * x_tab[cols.select(axis, e)].double(), acc)
        acc = torch.where(live.select(axis, e), new, acc)
    return acc


# k-major bins of fewer blocks (n_groups * 8) than about two waves of the 132
# SMs of an H100 split each row's slots over lanes: as many as give at most
# four 128-thread blocks an SM, at most 32 and at most a quarter of the row's
# K slots, so that every lane takes at least four (measured on an H100, the
# split rows of band-like and FEM bins: more blocks, or lanes of two or three
# slots, lost more to the joins and the spread loads than they won)
_KM_SPLIT_BELOW = 2 * 132
_KM_SPLIT_BLOCKS = 4 * 132
_KM_MAX_LANES = 32
_KM_MIN_SLOTS = 4


def _k_major_lanes(b: DeviceBinIndex) -> int:
    """Lanes a row of k-major bin ``b`` (a power of two): a function of the
    bin's shape only, so that the plain version sums in the kernel's
    order; a joint bin's are its members' (:class:`Joint`)."""
    if getattr(b, "lanes", 0):
        return b.lanes
    blocks = b.n_groups * SUBLANES
    if blocks == 0 or blocks >= _KM_SPLIT_BELOW:
        return 1
    lanes = 1
    while (lanes < _KM_MAX_LANES and 2 * lanes * _KM_MIN_SLOTS <= b.k
           and 2 * lanes * blocks <= _KM_SPLIT_BLOCKS):
        lanes *= 2
    return lanes


def _lane_split(t: torch.Tensor, lanes: int) -> torch.Tensor:
    """A k-major plane ``(n_groups, K, 8, 128)`` as the split kernel walks
    it: ``(n_groups, S, lanes, 8, 128)``, ``S = ceil(K / lanes)``, slot
    ``s*lanes + p`` at ``[:, s, p]`` and zeros past K (a zero value adds
    nothing)."""
    ng, k = t.shape[:2]
    steps = -(-k // lanes)
    pad = t.new_zeros((ng, steps * lanes - k) + tuple(t.shape[2:]))
    return torch.cat([t, pad], 1).view(ng, steps, lanes, *t.shape[2:])


def _lane_join(sums: tuple, combine) -> tuple:
    """The split kernel's join of each row's lane sums, a tuple of
    ``(n_groups, lanes, 8, 128)`` tensors: neighbouring lanes pairwise, the
    lower lane first, then neighbouring pairs, and so on, as its
    ``__shfl_xor_sync`` tree leaves them in the row's first lane;
    ``combine(a, b)`` takes and returns tuples. Returns ``(n_groups, 8,
    128)`` tensors."""
    while sums[0].shape[1] > 1:
        sums = combine(tuple(t[:, 0::2] for t in sums),
                       tuple(t[:, 1::2] for t in sums))
    return tuple(t[:, 0] for t in sums)


def k_major_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, i, j]``: the entries ``as[(g*K+k)*8+i, j] *
    x[ja[(g*K+k)*8+i, j]]`` that are not zero added with one fmaf each from
    0 (:func:`fma_f32`) in the kernel's order: in k order, or, split over G
    = :func:`_k_major_lanes` lanes, lane p's slots k = p, p + G, ... in
    order and the lanes joined by :func:`_lane_join`; so the kernel equals
    it bit for bit. A compacted bin (the dd layout of one lane a row, f32
    values), which no f32 kernel takes, sums as the row-list kernel does
    (:func:`_list_plain`)."""
    if b.row_table is not None:
        return _list_plain(b, x_tab)
    lanes = _k_major_lanes(b)
    shape = (b.n_groups, b.k, SUBLANES, LANES)
    vals = _lane_split(b.as_.view(shape), lanes)
    cols = _lane_split(b.ja.view(shape).long(), lanes)
    acc = torch.zeros(b.n_groups, lanes, SUBLANES, LANES, dtype=torch.float32,
                      device=x_tab.device)
    for st in range(vals.shape[1]):
        v = vals[:, st]
        new = fma_f32(v.double() * x_tab[cols[:, st]].double(), acc)
        acc = torch.where(v != 0, new, acc)
    return _lane_join((acc,), lambda u, w: (u[0] + w[0],))[0]


def wl_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, rb, j]``: row rb*128 + j's real slots (:func:`_wl_steps`) in
    the kernel's order, ``acc = fmaf(v, x[col], acc)`` from 0
    (:func:`fma_f32`), so the kernel equals it bit for bit."""
    acc = torch.zeros(b.n_groups * GROUP_ROWS, dtype=torch.float32,
                      device=x_tab.device)
    vals = b.as_.view(-1)
    for pos, cols, has in _wl_steps(b):
        v = vals[pos]
        new = fma_f32(v.double() * x_tab[cols].double(), acc)
        acc = torch.where(has & (v != 0), new, acc)
    return acc.view(b.n_groups, SUBLANES, LANES)


def _wl_padded(hb, device):
    """Host wl bin ``hb`` as the padded layout holds it: returns
    ``by_step``, which lays a plane of it out as ``(k, n_groups*1024)``,
    every row's ``k`` slots in the order (w, l, s), and the slots' columns
    laid out so."""
    ng, nw, L, k = hb.n_groups, hb.chunk_k, hb.span, hb.k

    def by_step(t):
        return t.reshape(ng, SUBLANES, nw, L, 8, LANES).permute(
            2, 3, 4, 0, 1, 5).reshape(k, ng * GROUP_ROWS)

    slab = torch.from_numpy(np.asarray(hb.slab_list, np.int64)).to(device)
    m = torch.from_numpy(np.asarray(hb.ja, np.int64)).to(device)
    return by_step, by_step(slab.view(ng, SUBLANES, nw, 1, 8, 1) * LANES
                            + m.view(ng, SUBLANES, nw, L, 8, LANES))


def wl_padded_plain(hb, x_tab: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """The padded wl kernel's function, which the compaction must keep: host
    bin ``hb``'s values rounded to ``dtype`` as the upload rounds them, and
    every one of a row's ``k`` slots, pads included, added in the order (w,
    l, s) with one fmaf each (:func:`fma_f32`); ``(n_groups, 8, 128)``. On
    finite x :func:`wl_bin_plain` of the compacted bin equals it bit for
    bit, up to the sign of a zero sum."""
    by_step, cols = _wl_padded(hb, x_tab.device)
    vals = by_step(_values(hb.as_, dtype, x_tab.device))
    acc = torch.zeros(cols.shape[1], dtype=torch.float32,
                      device=x_tab.device)
    for q in range(cols.shape[0]):
        acc = fma_f32(vals[q].double() * x_tab[cols[q]].double(), acc)
    return acc.view(hb.n_groups, SUBLANES, LANES)


def sb_major_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, sb, j] = sum_k as * x[col]`` over entries ``g*8K + sb*K + k``
    of lane j, col decoded as :func:`_sb_slots` says (int16 pads skipped)."""
    return _row_sums(b, x_tab)


def _list_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """A compacted bin's rows (sb-list, sg, k-major) as the row-list kernel
    sums them: each sorted row's slots (:func:`_list_steps`) in plane
    order, ``acc = fmaf(v, x[col], acc)`` from 0 (:func:`fma_f32`), zero
    values skipped; ``(n_groups, 8, 128)`` in row order."""
    acc = torch.zeros(b.n_groups * GROUP_ROWS, dtype=torch.float32,
                      device=x_tab.device)
    vals, cols = b.as_.view(-1), b.ja.view(-1)
    for pos, has in _list_steps(b):
        v = vals[pos]
        new = fma_f32(v.double() * x_tab[cols[pos].long()].double(), acc)
        acc = torch.where(has & (v != 0), new, acc)
    return _unsort(b, acc)


def sb_list_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """``out[g, sb, j]``: the row's real slots in entry order, ``acc =
    fmaf(v, x[col], acc)`` from 0 (:func:`fma_f32`), so the kernel equals it
    bit for bit: a compacted bin's sorted rows (:func:`_list_plain`), or a
    padded int16 bin's slots with its pads skipped (:func:`_sb_slots`)."""
    if b.row_table is None:
        return _in_order(b, x_tab)
    return _list_plain(b, x_tab)


def _sb_padded(hb, device):
    """Host sb-list bin ``hb`` with int32 planes as the padded layout holds
    it: its columns ``(n_groups, 8, k, 128)``, every row's k entries along
    axis 2."""
    shape = (hb.n_groups, SUBLANES, hb.k, LANES)
    return shape, torch.from_numpy(np.asarray(hb.ja, np.int64)).to(
        device).view(shape)


def sb_list_padded_plain(hb, x_tab: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """The padded sb-list kernel's function with int32 planes, which the
    compaction must keep: host bin ``hb``'s values rounded to ``dtype`` as
    the upload rounds them, and every one of a row's ``k`` slots, pads
    included, added in entry order with one fmaf each (:func:`fma_f32`);
    ``(n_groups, 8, 128)``. On finite x :func:`sb_list_bin_plain` of the
    compacted bin equals it bit for bit, up to the sign of a zero sum."""
    shape, cols = _sb_padded(hb, x_tab.device)
    vals = _values(hb.as_, dtype, x_tab.device).view(shape)
    acc = torch.zeros(hb.n_groups, SUBLANES, LANES, dtype=torch.float32,
                      device=x_tab.device)
    for e in range(hb.k):
        acc = fma_f32(vals[:, :, e].double() * x_tab[cols[:, :, e]].double(),
                      acc)
    return acc


# padded (dd) sg bins of fewer groups than two 1024-thread blocks an SM of an
# H100 (132 SMs) are split into chunks of tiles, enough for about four waves
# of two blocks an SM, each chunk at least _SG_MIN_CHUNK tiles
_SG_SPLIT_BELOW = 2 * 132
_SG_SPLIT_BLOCKS = 8 * 132
_SG_MIN_CHUNK = 16


def _sg_chunks(b: DeviceBinIndex) -> int:
    """Chunks of tiles per group of padded sg bin ``b``: a function of the
    bin's shape only, so that the plain version sums in the kernel's
    order; a joint bin's are its members' (:class:`Joint`)."""
    if getattr(b, "chunks", 0):
        return b.chunks
    if b.n_groups == 0 or b.n_groups >= _SG_SPLIT_BELOW:
        return 1
    return max(1, min(-(-_SG_SPLIT_BLOCKS // b.n_groups),
                      b.k // _SG_MIN_CHUNK))


def _sg_sums(b: DeviceBinIndex, prods: tuple, nonzero: torch.Tensor, add,
             combine, chunks: int) -> tuple:
    """Padded sg bin ``b``'s row sums in the tile kernel's order: chunk c of
    group g takes its real tiles ``[c*n/chunks, (c+1)*n/chunks)``, ``n =
    min(slab_count[g], k)``; slot (p, j) of each adds, in tile order, onto
    its own sum for row sigma (slots mode) or p (rows mode), where its value
    is not zero (``nonzero``, ``(n_groups, k, 8, 128)``); slots mode joins
    row sigma's 8 sums over p in order, and the chunks are joined in order.
    ``prods``: the slots' products, a tuple of ``(n_groups, k, 8, 128)``
    tensors; ``add(acc, prod)`` and ``combine(a, b)`` take and return tuples
    like it. Returns the tuple of ``(n_groups, 8, 128)`` sums."""
    ng, T = b.n_groups, b.k
    dev = prods[0].device
    n = b.slab_count.long().clamp(max=T)
    c = torch.arange(chunks, device=dev)
    t0 = c[None, :] * n[:, None] // chunks
    length = (c[None, :] + 1) * n[:, None] // chunks - t0  # (ng, chunks)
    gi = torch.arange(ng, device=dev)[:, None]
    shape = (ng, chunks, SUBLANES) + ((SUBLANES,) if b.sg_slots else ()) \
        + (LANES,)
    acc = tuple(torch.zeros(shape, dtype=torch.float32, device=dev)
                for _ in prods)
    if b.sg_slots:
        sigma = (b.ja.view(ng, T, SUBLANES, LANES).long() >> 7) \
            & (SUBLANES - 1)
    for s in range(int(length.max()) if length.numel() else 0):
        t = (t0 + s).clamp(max=T - 1)
        live = (s < length)[:, :, None, None] & nonzero[gi, t]
        step = tuple(pr[gi, t] for pr in prods)  # (ng, chunks, 8 p, 128)
        if b.sg_slots:
            idx = sigma[gi, t].unsqueeze(3)
            cur = tuple(a.gather(3, idx).squeeze(3) for a in acc)
            for a, new, old in zip(acc, add(cur, step), cur):
                a.scatter_(3, idx, torch.where(live, new, old).unsqueeze(3))
        else:
            acc = tuple(torch.where(live, new, old)
                        for new, old in zip(add(acc, step), acc))
    rows = tuple(a[:, :, 0] for a in acc) if b.sg_slots else acc
    for q in range(1, SUBLANES if b.sg_slots else 1):
        rows = combine(rows, tuple(a[:, :, q] for a in acc))
    out = tuple(r[:, 0] for r in rows)
    for ch in range(1, chunks):
        out = combine(out, tuple(r[:, ch] for r in rows))
    return out


def _sg_tile_sums(b: DeviceSellBin, x_tab: torch.Tensor,
                  chunks: int) -> torch.Tensor:
    """A padded sg bin's rows in the tile kernel's order (:func:`_sg_sums`),
    one fmaf a slot (:func:`fma_f32`)."""
    shape, cols, _, _ = _sg_slots(b)
    vals = b.as_.view(shape)
    prod = vals.double() * x_tab[cols].double()
    (out,) = _sg_sums(b, (prod,), vals != 0,
                      lambda a, p: (fma_f32(p[0], a[0]),),
                      lambda u, v: (u[0] + v[0],), chunks)
    return out


def sg_bin_plain(b: DeviceSellBin, x_tab: torch.Tensor) -> torch.Tensor:
    """A compacted sg bin's rows (:func:`_compact_sg`) as the row-list
    kernel sums them (:func:`_list_plain`): each row's real slots in (tile,
    p) order with one fmaf each, so the kernel equals it bit for bit. A
    padded bin (the dd layout's tiles, f32 values), which no f32 kernel
    takes, sums in the tile kernel's order (:func:`_sg_tile_sums`)."""
    if b.row_table is None:
        return _sg_tile_sums(b, x_tab, _sg_chunks(b))
    return _list_plain(b, x_tab)


def sg_padded_plain(hb, x_tab: torch.Tensor, dtype=torch.float32,
                    chunks: int | None = None) -> torch.Tensor:
    """The padded sg layout's function, which the compaction must keep: host
    bin ``hb``'s values rounded to ``dtype`` as the upload rounds them, each
    real slot's ``as * x[col]`` (:func:`_sg_slots`) whose value is not zero
    added with one fmaf (:func:`fma_f32`) onto row ``sigma*128 + j``,
    ``sigma = (md>>7)&7`` (slots mode) or ``sigma = p`` (rows mode), in the
    padded tile kernel's order (:func:`_sg_sums`, ``chunks`` by default
    :func:`_sg_chunks`'); ``(n_groups, 8, 128)``. The compacted bin's sums
    add the same products in another order, so they agree within f32
    rounding."""
    b = DeviceSellBin(**_put_bin_index(hb, x_tab.device, False),
                      as_=_values(hb.as_, dtype, x_tab.device))
    return _sg_tile_sums(b, x_tab, chunks or _sg_chunks(b))


_PLAIN = {"k-major": k_major_bin_plain, "wl": wl_bin_plain,
          "sb-major": sb_major_bin_plain, "sb-list": sb_list_bin_plain,
          "sg": sg_bin_plain}


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch the kernel, CPU tensors run the plain version
# ---------------------------------------------------------------------------


def _check_bin(b: DeviceBinIndex, values: dict, device: torch.device,
               value_types: tuple, pairs: bool = False):
    """Check a bin's own tensors for a launch on ``device`` (x's): there and
    contiguous, int32 tables, the layout's index type, ``value_types``
    values (``pairs``: (hi, lo) pairs, a trailing axis of 2), and matching
    sizes."""
    tensors = {"group_ids": b.group_ids, "ja": b.ja, "slab_list": b.slab_list,
               "slab_count": b.slab_count, **values}
    tables = ["group_ids", "slab_list", "slab_count"]
    # the row-list layouts: sb-list with int32 planes, sg in f32 and bf16,
    # compacted k-major (dd)
    listed = (b.layout == "sb-list" and b.ja.dtype == torch.int32) or (
        b.layout == "sg" and not pairs) or (b.layout == "k-major"
                                            and b.row_table is not None)
    if b.layout == "wl":
        if b.row_len is None or b.plane_off is None:
            raise ValueError("wl bin without row_len / plane_off: upload it "
                             "with device_put_sell")
        tensors.update(row_len=b.row_len, plane_off=b.plane_off)
        tables += ["row_len", "plane_off"]
    elif listed:
        if b.row_table is None or b.plane_off is None:
            what = {"sb-list": "sb-list bin with int32 planes",
                    "sg": "f32/bf16 sg bin",
                    "k-major": "compacted k-major dd bin"}[b.layout]
            raise ValueError(f"{what} without row_table / plane_off: upload "
                             "it with device_put_sell")
        tensors.update(row_table=b.row_table, plane_off=b.plane_off)
        tables += ["row_table", "plane_off"]
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name in tables:
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    ja_types = {"wl": (torch.int16,), "sb-major": (torch.int32, torch.int16),
                "sb-list": (torch.int32, torch.int16)}.get(b.layout,
                                                           (torch.int32,))
    if b.ja.dtype not in ja_types:
        raise ValueError(f"{b.layout} index plane must be "
                         f"{' or '.join(map(str, ja_types))}, got {b.ja.dtype}")
    slots = b.ja.numel() if b.layout == "wl" or listed \
        else b.n_groups * b.k * SUBLANES * LANES
    for name, t in values.items():
        if t.dtype not in value_types:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(map(str, value_types))}, got "
                             f"{t.dtype}")
        if t.numel() != slots * (2 if pairs else 1) or (
                pairs and t.shape[-1] != 2):
            raise ValueError(f"{name} does not match the bin's shape")
    if b.layout == "wl":
        if (b.ja.numel() % LANES or b.row_len.numel() != b.n_groups
                * GROUP_ROWS or b.plane_off.numel() != b.n_groups * SUBLANES
                + 1):
            raise ValueError("wl planes do not match the bin's groups")
    elif listed:
        if (b.ja.numel() % _WARP or b.row_table.numel() != b.n_groups
                * GROUP_ROWS or b.plane_off.numel() != b.n_groups
                * GROUP_ROWS // _WARP + 1):
            raise ValueError(f"{b.layout} planes do not match the bin's "
                             "groups")
    elif b.ja.numel() != slots:
        raise ValueError("index plane does not match the value plane")
    if b.n_groups * SUBLANES > _INT32_MAX:
        raise ValueError("the bin's grid is beyond 32-bit indexing")


def _check_launch(b: DeviceBinIndex, values: dict, xs: dict, ys: dict,
                  value_types: tuple, pairs: bool = False):
    """Check what a kernel launch reads and writes: every tensor on the
    device of the first x and contiguous, the bin's tensors as
    :func:`_check_bin` says (``pairs``: (hi, lo) value pairs), f32 x and y,
    and matching sizes."""
    x0 = next(iter(xs.values()))
    if x0.device.type != "cuda":
        raise RuntimeError(
            f"SELL kernels run on CUDA or CPU tensors, not {x0.device}")
    for name, t in {**xs, **ys}.items():
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    _check_bin(b, values, x0.device, value_types, pairs)
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
    if b.row_table is not None:  # _compact_km
        return ("sell_k_major", "_list", (b.group_ids, b.plane_off,
                                          b.row_table, b.ja), (b.n_groups,))
    return ("sell_k_major", "", (b.group_ids, b.ja),
            (b.n_groups, b.k, _k_major_lanes(b)))


def _wl_call(b):
    _check_table(b, b.n_groups * SUBLANES * b.nw * 8, "slab table")
    return ("sell_wl", "", (b.group_ids, b.slab_list, b.plane_off, b.row_len,
                            b.ja), (b.n_groups, b.nw))


def _sb_call(b):
    if b.layout == "sb-list" and b.ja.dtype == torch.int32:  # _compact_sl
        return ("sell_sb_list", "", (b.group_ids, b.plane_off, b.row_table,
                                     b.ja), (b.n_groups,))
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
    if b.row_table is not None:  # _compact_sg
        return ("sell_sg", "", (b.group_ids, b.plane_off, b.row_table, b.ja),
                (b.n_groups,))
    stride = 2 if b.span == 0 else 1
    _check_table(b, b.n_groups * b.k * stride, "window table")
    if b.slab_count.numel() != b.n_groups:
        raise ValueError("sg tile counts do not match the bin's groups")
    return ("sell_sg", "", (b.group_ids, b.slab_list, b.slab_count, b.ja),
            (b.n_groups, b.k, stride, int(b.sg_slots), _sg_chunks(b)))


def _scratch(b: DeviceBinIndex, device, pairs: bool = False) -> tuple:
    """The padded sg kernel's last operand: its split's partial sums,
    ``(n_groups, chunks, 1024)`` f32 (``pairs``: (hi, lo) pairs), empty
    when it is not split; no operand for the other layouts and for
    compacted sg bins."""
    if b.layout != "sg" or b.row_table is not None:
        return ()
    chunks = _sg_chunks(b)
    n = b.n_groups * chunks * GROUP_ROWS * (2 if pairs else 1)
    return (torch.empty(n if chunks > 1 else 0, dtype=torch.float32,
                        device=device),)


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
    bf16 = b.as_.dtype == torch.bfloat16
    _launch(wrapper, b, "bf16" if bf16 else "f32",
            (b.as_, x_tab, y, *_scratch(b, x_tab.device)), accumulate)
    wrapper.launches_bf16 += bf16


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
    _w.launches_bf16 = 0


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


# ---------------------------------------------------------------------------
# the launch plan: bins that share a kernel go out as one launch
# ---------------------------------------------------------------------------

# a bin's value planes: f32/bf16 as_; dd as_hi and as_lo, or as_pair
_VALUE_FIELDS = ("as_", "as_hi", "as_lo", "as_pair")
# the tensors a joint bin's members share as views of its storage, in this
# order of allocation (group ids only where they are not rebased)
_SHARED = ("ja", *_VALUE_FIELDS, "row_len", "row_table", "slab_list",
           "slab_count", "group_ids")


@dataclass
class Joint:
    """One launch of a plan: ``bin`` runs the groups of ``members`` (bins
    that share a launch key, :func:`_launch_key`), in that order, fewest
    groups first, so that the small bins' blocks start in the first wave.
    Its index and value planes and per-group tables are one allocation of
    which each member's are views; its own tables are ``plane_off``
    rebased, a wl bin's slab lists padded to the widest ``nw`` (no 2-byte
    code reads past its own; per-block offsets instead ran the bf16 wl
    kernel 33% slower on the headline on an H100), the group ids of panel
    slices rebased. Each row's arithmetic is its
    member's, so the launch equals the members' launches bit for bit.
    ``accumulate``: the launch adds onto y (``add_into`` bins)."""

    bin: DeviceBinIndex
    members: tuple
    accumulate: bool = False


@dataclass
class LaunchPlan:
    """:func:`sell_spmv`'s "auto" launches: the core joint launches, which
    store their rows, then the ``add_into`` ones, in order; the core bins
    write ``covered`` groups (y takes no zero fill when that is all of
    them). ``bins``: the bins it was built from. ``dd_x``: which x tables
    the dd launches gather from, ``(pair, halves)``, worked out once a plan
    by :func:`.sell_dd._x_reads`."""

    launches: list
    covered: int
    bins: tuple
    dd_x: tuple | None = None

    @property
    def kernels(self) -> int:
        return len(self.launches)


@dataclass
class PanelPlan:
    """:func:`panel_sell_spmv`'s launches: the joint launches, each storing
    its members' rows into their slices of a scratch y of ``slices *
    num_groups`` groups (a panel's core bins share one slice, each
    ``add_into`` bin has one of its own, panel by panel), then
    :func:`panel_reduce` over ``cover`` ``(slices, num_groups)`` uint8, 1
    where a bin writes the group."""

    launches: list
    slices: int
    cover: torch.Tensor
    bins: tuple

    @property
    def kernels(self) -> int:
        return len(self.launches) + 1


def _launch_key(b: DeviceBinIndex) -> tuple:
    """What a bin's launch shares with the bins it may join: the C entry
    :data:`_CALL` picks, the index and value types, and every scalar the
    launch passes beyond its group count, but for wl's ``nw`` (a joint's
    slab lists are padded to the widest) and sb-major's span (neither of
    its decodes reads it)."""
    stem, suffix, _, after = _CALL[b.layout](b)
    scalars = () if b.layout == "wl" else after[1:]
    if b.layout == "sb-major":
        scalars = scalars[:2]
    values = tuple((f, getattr(b, f).dtype) for f in _VALUE_FIELDS
                   if getattr(b, f, None) is not None)
    return stem, suffix, b.ja.dtype, values, scalars


def _share(members: list, name: str) -> torch.Tensor:
    """One allocation holding every member's ``name`` tensor, along its
    first axis in member order; each member's becomes a view of its slice.
    The members' own are moved to the host first and freed on the device,
    so that no plane is held twice there."""
    parts = [getattr(m, name).cpu() for m in members]
    device = getattr(members[0], name).device
    for m in members:
        setattr(m, name, None)
    out = torch.empty((sum(p.shape[0] for p in parts), *parts[0].shape[1:]),
                      dtype=parts[0].dtype, device=device)
    at = 0
    for m, p in zip(members, parts):
        out[at:at + p.shape[0]].copy_(p)
        setattr(m, name, out[at:at + p.shape[0]])
        at += p.shape[0]
    return out


def _join(members: list, group_ids: list | None = None) -> DeviceBinIndex:
    """The joint bin of ``members`` (one launch key, in block order). With
    ``group_ids`` (a tensor a member) the joint's group ids are those,
    rebased, else the members' shared; a lone member whose ids are not
    rebased is its own joint bin."""
    first = members[0]
    if len(members) == 1:
        if group_ids is None:
            return first
        return dataclasses.replace(first, add_into=False,
                                   group_ids=group_ids[0].to(torch.int32))
    fields = {f.name: getattr(first, f.name)
              for f in dataclasses.fields(first)}
    if first.plane_off is not None:  # rebased on each member's plane rows
        rows = torch.tensor([0] + [m.ja.shape[0] for m in members],
                            device=first.ja.device).cumsum(0)
        fields["plane_off"] = torch.cat(
            [m.plane_off[:-1] + int(r) for m, r in zip(members, rows)]
            + [rows[-1:]]).to(torch.int32)
    if first.layout == "wl":  # padded to the widest window count
        nw = max(m.nw for m in members)
        fields["chunk_k"] = nw
        fields["slab_list"] = torch.cat([torch.nn.functional.pad(
            m.slab_list.view(-1, m.nw * 8), (0, (nw - m.nw) * 8)).view(-1)
            for m in members])
    for name in _SHARED:
        if name == "group_ids" and group_ids is not None:
            fields[name] = torch.cat(group_ids).to(torch.int32)
        elif name == "slab_list" and first.layout == "wl":
            continue
        elif fields.get(name) is not None:
            fields[name] = None  # let _share free the first member's
            fields[name] = _share(members, name)
    if first.layout == "k-major":
        fields["lanes"] = _k_major_lanes(first)
        if "x_window" in fields:  # the SpMM kernel's: the members keep theirs
            fields.update(x_window=None, window_rows=0)
    if first.layout == "sg" and first.row_table is None:
        fields["chunks"] = _sg_chunks(first)
    fields.update(n_groups=sum(m.n_groups for m in members),
                  k=max(m.k for m in members),
                  add_into=first.add_into and group_ids is None)
    return type(first)(**fields)


def _check_layouts(bins):
    for b in bins:
        if b.layout not in _KERNEL:
            raise ValueError(f"unknown SELL bin layout {b.layout!r}")


def _disjoint(run: list, b: DeviceBinIndex) -> bool:
    held = torch.cat([m.group_ids for m in run])
    return not bool(torch.isin(b.group_ids, held).any())


def _flat_plan(bins: list) -> LaunchPlan:
    """The plan of one SELL's bins: the core bins that share a launch key
    join (their groups are disjoint: each group is one core bin's); an
    ``add_into`` bin joins the launch before it where it shares its key and
    none of its groups, so that every row's sums are added in bin order."""
    core = [b for b in bins if not b.add_into]
    keyed = {}
    for b in core:
        keyed.setdefault(_launch_key(b), []).append(b)
    launches = []
    for members in keyed.values():
        members = sorted(members, key=lambda m: m.n_groups)
        launches.append(Joint(_join(members), tuple(members)))
    runs = []
    for b in (b for b in bins if b.add_into):
        if runs and _launch_key(b) == _launch_key(runs[-1][0]) \
                and _disjoint(runs[-1], b):
            runs[-1].append(b)
        else:
            runs.append([b])
    for run in runs:
        run = sorted(run, key=lambda m: m.n_groups)
        launches.append(Joint(_join(run), tuple(run), True))
    ids = torch.cat([b.group_ids for b in core]) if core else \
        torch.zeros(0, dtype=torch.int32)
    covered = int(torch.unique(ids).numel())
    if covered != ids.numel():
        raise ValueError("two core bins write the same group: each group "
                         "belongs to one core bin")
    return LaunchPlan(launches, covered, tuple(bins))


def _panel_plan(dps) -> PanelPlan:
    """The plan of column panels: slice s of the scratch y takes panel p's
    core bins, or one of its ``add_into`` bins, panel by panel and in each
    panel the core slice first, so that :func:`panel_reduce` adds the
    slices in the order of the panel-by-panel accumulation. Every bin
    stores into its slice (group ids rebased to ``s*num_groups + g``), so
    the bins of all panels that share a launch key join."""
    ng = dps.num_groups
    entries, slices = [], 0  # (bin, slice)
    for dsell in dps.panels:
        core = [b for b in dsell.bins if not b.add_into]
        adds = [b for b in dsell.bins if b.add_into]
        entries += [(b, slices) for b in core]
        slices += bool(core)
        entries += [(b, slices + i) for i, b in enumerate(adds)]
        slices += len(adds)
    device = entries[0][0].ja.device if entries else torch.device("cpu")
    cover = torch.zeros(slices, ng, dtype=torch.uint8, device=device)
    keyed = {}
    for b, sl in entries:
        cover[sl, b.group_ids.long()] = 1
        keyed.setdefault(_launch_key(b), []).append((b, sl))
    launches = []
    for pairs in keyed.values():
        pairs = sorted(pairs, key=lambda e: e[0].n_groups)
        members = [b for b, _ in pairs]
        launches.append(Joint(_join(members, [b.group_ids + sl * ng
                                               for b, sl in pairs]),
                              tuple(members)))
    return PanelPlan(launches, slices, cover, tuple(b for b, _ in entries))


def _bins_of(d) -> list:
    return [b for p in d.panels for b in p.bins] if hasattr(d, "panels") \
        else list(d.bins)


def _plan_of(d):
    """``d``'s launch plan: the one built at upload, or, where ``d``'s bins
    were replaced since, one built now. Every bin's layout is checked."""
    bins = _bins_of(d)
    _check_layouts(bins)
    plan = d.plan
    if plan is None or {id(b) for b in plan.bins} != {id(b) for b in bins}:
        plan = d.plan = (_panel_plan(d) if hasattr(d, "panels")
                         else _flat_plan(bins))
    return plan


def plan_bytes(d) -> int:
    """Device bytes of ``d``'s launch plan beyond its bins' own tensors:
    the joint bins' tables (rebased ``plane_off``, padded wl slab lists,
    rebased group ids) and a panel plan's cover table."""
    plan = _plan_of(d)

    def storages(b):
        return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in vars(b).values() if isinstance(t, torch.Tensor)}

    owned = {}
    for b in plan.bins:
        owned |= storages(b)
    extra = {}
    for j in plan.launches:
        extra |= {k: v for k, v in storages(j.bin).items()
                  if k not in owned}
    cover = getattr(plan, "cover", None)
    return sum(extra.values()) + (cover.numel() if cover is not None else 0)


def _assemble(dsell, xs: tuple, write, plan=None, plain=False) -> tuple:
    """One y per x table by ``dsell``'s launch plan (``plan``, where the
    caller holds it from :func:`_plan_of`): the core joint launches store
    their groups' rows, then the ``add_into`` ones add onto them, on one
    stream; returns each ``y[:nrows]``, or the ys through ``dsell.row_map``
    where it has one (:func:`_in_caller_order`; ``plain``: by the plain
    versions). y is zero-filled only where the core bins do not write every
    group. ``write(b, *xs, *ys, accumulate)`` runs one (joint) bin."""
    for x_tab in xs:
        _check_x_table(dsell, x_tab)
    plan = _plan_of(dsell) if plan is None else plan
    new = torch.empty if plan.covered == dsell.num_groups else torch.zeros
    ys = tuple(new(dsell.num_groups * GROUP_ROWS, dtype=torch.float32,
                   device=xs[0].device) for _ in xs)
    for j in plan.launches:
        write(j.bin, *xs, *ys, j.accumulate)
    return _in_caller_order(dsell, ys, plain)


def _in_caller_order(dsell, ys: tuple, plain=False) -> tuple:
    """Each ``y[:nrows]``, or, for a container with a row map, the ys
    gathered through it into the caller's row order: one f32 y by
    :func:`row_gather`, a (hi, lo) pair by :func:`row_gather_dd` (``plain``:
    their plain versions)."""
    row_map = getattr(dsell, "row_map", None)
    if row_map is None:
        return tuple(y[: dsell.nrows] for y in ys)
    if len(ys) == 1:
        return ((row_gather_plain if plain else row_gather)(ys[0], row_map),)
    return (row_gather_dd_plain if plain else row_gather_dd)(*ys, row_map)


def _segments(row_map: RowMap):
    """Per step k of the longest row's segments: the rows that have a k-th
    segment and its sorted position."""
    ptr, pos = row_map.ptr.long(), row_map.pos.long()
    count = ptr[1:] - ptr[:-1]
    for k in range(int(count.max()) if count.numel() else 0):
        rows = (count > k).nonzero()[:, 0]
        yield rows, pos[ptr[rows] + k]


def row_gather_plain(src: torch.Tensor, row_map: RowMap) -> torch.Tensor:
    """``y[r]``: ``src`` at row r's segments (``row_map``), added in order
    in f32 from +0; +0 for a row with none."""
    y = torch.zeros(row_map.ptr.numel() - 1, dtype=torch.float32,
                    device=src.device)
    for rows, at in _segments(row_map):
        y[rows] = y[rows] + src[at]
    return y


def row_gather_dd_plain(src_hi: torch.Tensor, src_lo: torch.Tensor,
                        row_map: RowMap) -> tuple:
    """The (hi, lo) pair of :func:`row_gather_plain`: each row's segments
    added in order onto (0, 0) by ``dd_add_dd(acc, segment)``."""
    h = torch.zeros(row_map.ptr.numel() - 1, dtype=torch.float32,
                    device=src_hi.device)
    l = torch.zeros_like(h)
    for rows, at in _segments(row_map):
        h[rows], l[rows] = dd_add_dd(h[rows], l[rows], src_hi[at],
                                     src_lo[at])
    return h, l


def _check_gather(srcs: tuple, row_map: RowMap):
    dev = srcs[0].device
    if any(t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous()
           or t.device != dev or t.numel() < row_map.src_rows
           for t in srcs) or any(
            t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
            or t.device != dev for t in (row_map.ptr, row_map.pos)):
        raise ValueError("row_gather takes contiguous f32 vectors of the "
                         "row map's src_rows entries or more and a row map "
                         "of contiguous int32 vectors on their device")


def _launch_gather(name: str, srcs: tuple, row_map: RowMap, ys: tuple):
    dev = srcs[0].device
    with torch.cuda.device(dev):
        err = getattr(_build.load(), name)(
            *(t.data_ptr() for t in (*srcs, row_map.ptr, row_map.pos, *ys)),
            ys[0].numel(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def row_gather(src: torch.Tensor, row_map: RowMap) -> torch.Tensor:
    """:func:`row_gather_plain` as one CUDA kernel (``row_gather_f32``,
    ``csrc/row_map.cu``) on CUDA tensors, bit for bit; the plain version on
    CPU ones. Counts its launches in ``.launches``."""
    if src.device.type == "cpu":
        return row_gather_plain(src, row_map)
    _check_gather((src,), row_map)
    y = torch.empty(row_map.ptr.numel() - 1, dtype=torch.float32,
                    device=src.device)
    _launch_gather("row_gather_f32", (src,), row_map, (y,))
    row_gather.launches += 1
    return y


def row_gather_dd(src_hi: torch.Tensor, src_lo: torch.Tensor,
                  row_map: RowMap) -> tuple:
    """:func:`row_gather_dd_plain` as one CUDA kernel (``row_gather_dd``,
    ``csrc/row_map.cu``) on CUDA tensors, bit for bit; the plain version on
    CPU ones. Counts its launches in ``.launches``."""
    if src_hi.device.type == "cpu":
        return row_gather_dd_plain(src_hi, src_lo, row_map)
    _check_gather((src_hi, src_lo), row_map)
    ys = tuple(torch.empty(row_map.ptr.numel() - 1, dtype=torch.float32,
                           device=src_hi.device) for _ in range(2))
    _launch_gather("row_gather_dd", (src_hi, src_lo), row_map, ys)
    row_gather_dd.launches += 1
    return ys


row_gather.launches = 0
row_gather_dd.launches = 0


ASSEMBLIES = ("auto", "sum", "chain")


def sell_spmv_launches(d, assembly: str = "auto") -> int:
    """The CUDA launches one :func:`sell_spmv` call queues: "auto", the
    plan's joint launches and, where the core bins do not write every
    group, a zero fill of y; "chain", a zero fill and a kernel per bin;
    "sum" (more than one bin), a zero fill and a zero fill, a kernel and an
    add per bin; each, with a row map, one :func:`row_gather`. Column
    panels (:func:`panel_sell_spmv`): the x table's zero fill and copy,
    the plan's joint launches and :func:`panel_reduce`."""
    if isinstance(d, DevicePanelSell):
        return 2 + _plan_of(d).kernels
    gather = d.row_map is not None
    if assembly == "auto":
        plan = _plan_of(d)
        return plan.kernels + (plan.covered != d.num_groups) + gather
    n = len(d.bins)
    return 1 + (3 * n if assembly == "sum" and n > 1 else n) + gather


def _spmv(dsell: DeviceSell, x_tab: torch.Tensor, write,
          assembly: str, plain=False) -> torch.Tensor:
    if not isinstance(dsell, DeviceSell):
        raise TypeError(f"sell_spmv takes a DeviceSell, got "
                        f"{type(dsell).__name__} (column panels: "
                        "panel_sell_spmv; dd: sell_spmv_dd)")
    if assembly not in ASSEMBLIES:
        raise ValueError(f"assembly {assembly!r}: one of {ASSEMBLIES}")
    if assembly == "auto":
        return _assemble(dsell, (x_tab,), write, plain=plain)[0]
    _check_x_table(dsell, x_tab)

    def zeros():
        return torch.zeros(dsell.num_groups * GROUP_ROWS,
                           dtype=torch.float32, device=x_tab.device)

    y = zeros()
    if assembly == "sum" and len(dsell.bins) > 1:
        # every bin stores into its own zeroed y; the y's summed in bin order
        parts = []
        for b in dsell.bins:
            parts.append(zeros())
            write(b, x_tab, parts[-1], False)
        for part in parts:
            y = y + part
    else:  # one y through every bin
        # a core bin stores its groups' rows: after an add_into bin of the
        # same groups it would overwrite that bin's sums
        adds = [b.add_into for b in dsell.bins]
        if any(adds[i] and not adds[j] for i in range(len(adds))
               for j in range(i + 1, len(adds))):
            raise ValueError("assembly 'chain' runs the bins in order: a "
                             "core bin after an add_into bin would "
                             "overwrite its sums")
        for b in dsell.bins:
            write(b, x_tab, y, b.add_into)
    return _in_caller_order(dsell, (y,), plain)[0]


def sell_spmv(dsell: DeviceSell, x_tab: torch.Tensor,
              assembly: str = "auto") -> torch.Tensor:
    """``y = A @ x`` over the binned SELL layout; returns ``y[:nrows]`` (f32).

    ``x_tab`` is x padded by :func:`device_put_x` or :func:`pack_x_table`.
    CUDA tensors run the CUDA kernels, CPU tensors the plain versions.
    ``assembly`` (≙ the JAX ``sell_spmv_pallas``'s):

    * ``"auto"``: core bins store their own groups' rows, then ``add_into``
      bins add onto them;
    * ``"sum"``: every bin stores into its own zeroed y, and the y's are
      summed in bin order (one bin: as "chain");
    * ``"chain"``: one y through every bin in bin order, each bin adding
      onto it when it is ``add_into``; a core bin after an ``add_into`` bin
      raises ``ValueError`` (it would overwrite that bin's sums).

    A container whose host SELL the port's row-order rule sorted
    (``row_map``) returns y in the caller's row order (:func:`row_gather`,
    one launch more), its rows with no entry 0.

    :func:`sell_spmv_launches` gives the launches one call queues."""
    with annotate("ops.sell_spmv"):
        return _spmv(dsell, x_tab, _run_kernel, assembly)


def sell_spmv_plain(dsell: DeviceSell, x_tab: torch.Tensor,
                    assembly: str = "auto") -> torch.Tensor:
    """:func:`sell_spmv` through the plain versions on any device — the
    reference the kernels are held against."""
    return _spmv(dsell, x_tab, _write_plain, assembly, plain=True)


def panel_x_table(dps, x: torch.Tensor) -> torch.Tensor:
    """The one x table of column panels: the unpadded f32 x, zero-padded to
    ``dps.x_rows`` entries, which every panel's rebased bins read."""
    return _x_table(x, dps.x_rows)


def _assemble_panels(dps, xs: tuple, write, reduce) -> tuple:
    """One y per unpadded x vector by ``dps``'s launch plan: x packed once,
    every joint launch storing its members' rows into their slices of a
    scratch y, then ``reduce(*parts, cover, *ys)`` adding the slices into
    y (:func:`panel_reduce`); returns each ``y[:nrows]``."""
    plan = _plan_of(dps)
    tabs = tuple(panel_x_table(dps, x) for x in xs)
    n = dps.num_groups * GROUP_ROWS
    parts = tuple(torch.empty(plan.slices * n, dtype=torch.float32,
                              device=xs[0].device) for _ in xs)
    for j in plan.launches:
        write(j.bin, *tabs, *parts, False)
    ys = tuple(torch.empty(n, dtype=torch.float32, device=xs[0].device)
               for _ in xs)
    reduce(*parts, plan.cover, *ys)
    return tuple(y[: dps.nrows] for y in ys)


def panel_reduce_plain(parts: torch.Tensor,
                       cover: torch.Tensor) -> torch.Tensor:
    """y of column panels from their slices ``parts`` (``slices *
    num_groups * 1024``): each row's covered slices (``cover[s, g]``) added
    in slice order onto +0, ``acc = acc + part``, the order and operands of
    the kernels' accumulating store (``sell_common.cuh``), so a zero sum's
    sign is that of the accumulation too."""
    slices, ng = cover.shape
    parts = parts.view(slices, ng, GROUP_ROWS)
    acc = torch.zeros(ng, GROUP_ROWS, dtype=torch.float32,
                      device=parts.device)
    for s in range(slices):
        acc = torch.where(cover[s].bool()[:, None], acc + parts[s], acc)
    return acc.view(-1)


def _check_reduce(parts: tuple, cover: torch.Tensor, ys: tuple):
    """Check a :func:`panel_reduce` launch: every tensor on one CUDA device
    and contiguous, f32 slices of ``slices * num_groups * 1024`` entries, a
    uint8 cover table and f32 y of ``num_groups * 1024``."""
    device = ys[0].device
    if device.type != "cuda":
        raise RuntimeError(f"panel_reduce runs on CUDA or CPU tensors, not "
                           f"{device}")
    slices, ng = cover.shape
    for name, t, n in [("parts", p, slices * ng * GROUP_ROWS) for p in parts] \
            + [("y", y, ng * GROUP_ROWS) for y in ys]:
        if t.device != device or not t.is_contiguous() \
                or t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"{name} must be a contiguous f32 tensor of {n} "
                             f"entries on {device}")
    if cover.device != device or cover.dtype != torch.uint8 \
            or not cover.is_contiguous():
        raise ValueError(f"cover must be a contiguous uint8 table on {device}")


def panel_reduce(parts: torch.Tensor, cover: torch.Tensor, y: torch.Tensor):
    """y (``num_groups * 1024``) of column panels from their slices: the
    CUDA kernel ``panel_reduce_f32`` (``csrc/panel_reduce.cu``) on CUDA
    tensors, :func:`panel_reduce_plain` on CPU ones; counts its launches in
    ``.launches``."""
    if y.device.type == "cpu":
        y.copy_(panel_reduce_plain(parts, cover))
        return
    _check_reduce((parts,), cover, (y,))
    _launch_reduce(panel_reduce, "panel_reduce_f32", (parts,), cover, (y,))


panel_reduce.launches = 0


def _launch_reduce(wrapper, name: str, parts: tuple, cover: torch.Tensor,
                   ys: tuple):
    device = ys[0].device
    with torch.cuda.device(device):
        err = getattr(_build.load(), name)(
            *(t.data_ptr() for t in (*parts, cover, *ys)), cover.shape[1],
            cover.shape[0], torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1


def _check_panel_x(dps, x: torch.Tensor):
    if x.dtype != torch.float32 or tuple(x.shape) != (dps.ncols,):
        raise ValueError(f"x must be an f32 vector of {dps.ncols} entries, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _panel_spmv(dps: DevicePanelSell, x: torch.Tensor, write) -> torch.Tensor:
    if not isinstance(dps, DevicePanelSell):
        raise TypeError(f"panel_sell_spmv takes a DevicePanelSell, got "
                        f"{type(dps).__name__}")
    _check_panel_x(dps, x)
    return _assemble_panels(dps, (x,), *write)[0]


def panel_sell_spmv(dps: DevicePanelSell, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` over column panels (≙ the JAX ``_panel_spmv``): x is the
    unpadded f32 vector on the device, packed once into the table every
    panel's rebased bins read; the plan's joint launches write each panel's
    partial rows into their slices and :func:`panel_reduce` adds them into
    y in the order of a panel-by-panel accumulation."""
    return _panel_spmv(dps, x, (_run_kernel, panel_reduce))


def _reduce_plain(parts, cover, y):
    y.copy_(panel_reduce_plain(parts, cover))


def panel_sell_spmv_plain(dps: DevicePanelSell,
                          x: torch.Tensor) -> torch.Tensor:
    """:func:`panel_sell_spmv` through the plain versions."""
    return _panel_spmv(dps, x, (_write_plain, _reduce_plain))
