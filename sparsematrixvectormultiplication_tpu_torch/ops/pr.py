"""PR (permutation-routed) SpMV in PyTorch: upload, the kernel and its plain
version.

Counterpart of the JAX package's ``ops/pallas_pr.py`` (``_kernel_pr`` ->
``csrc/pr.cu`` ``pr_spmv_f32``). A host :class:`~..formats.pr.PRMatrix`
holds its entries in global column order on ``(n_rows, 128)`` planes
(``val``, ``md``; row r reads x slab ``row_slab[r]``) and the routing that
moves each product to a sigma-ordered k-major slot array: ``2*log2(n_rows)-1``
Beneš exchange stages (bit s of ``masks``, partner ``i ^ d_s``) and a final
lane gather (``final_lane``). Each K-bin ``(K, G, off, g0)`` then sums the K
slots of its rows.

:func:`device_put_pr` uploads the planes and composes the stages and the
lane gather into one int32 plane ``route`` (:func:`compose_route`): the
source slot whose product lands at destination ``(r, l)``. The kernel reads
``route``; the plain version :func:`pr_problem_plain` runs the stages
themselves, step by step as the TPU kernel does, from the host ``masks`` and
``final_lane`` (uploaded at its first call on a device, never for the
kernel), so comparing the two on the card puts the composed plane under
test.

:func:`pr_problem` is the kernel's wrapper (one launch per PR problem,
counted in ``.launches``): CUDA tensors launch the kernel or raise, CPU
tensors run the plain version. :func:`pr_spmv` returns y in sigma row order,
cropped to ``nrows``, panels concatenated — callers unpermute with the host
matrix's ``unpermute`` / ``row_perm``.

The TPU kernel's window classes (``tile_base``, ``tile_far``, the ``md >> 7``
deltas), its upload cap and its VMEM limit are TPU matters: a GPU thread
reads ``x[128*row_slab[r] + (md & 127)]`` directly, so none is carried over.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.pr_route import benes_stage_distances
from ..formats.sell import LANES, SUBLANES, slab_table_rows
from . import _build

__all__ = ["DevicePRIndex", "DevicePR", "DevicePanelPR", "device_put_pr",
           "compose_route", "pr_problem", "pr_problem_plain", "pr_spmv",
           "pr_spmv_plain"]

_UNROLL_K = 16  # the TPU kernel sums K <= 16 as a pairwise tree


@dataclass(kw_only=True)
class DevicePRIndex:
    """The index side of one PR problem on a device, shared by the f32
    problem here and the double-double one of :mod:`.pr_dd`."""

    nrows: int
    ncols: int
    nnz: int
    n_rows: int               # Beneš rows (a power of two)
    y_rows: int               # output rows of 128 (n_groups * 8)
    bins: tuple               # ((K, G, off, g0), ...) on the host
    bin_table: torch.Tensor   # (n_bins, 4) int32, the same on the device
    md: torch.Tensor          # (n_rows, 128) int32; lane = md & 127
    row_slab: torch.Tensor    # (n_rows,) int32 x slab of each source row
    route: torch.Tensor       # (n_rows, 128) int32 composed source slot
    max_slab: int             # max(row_slab): the x table must reach it
    masks: np.ndarray         # (n_rows, 128) int32 Beneš swap bits, host
    final_lane: np.ndarray    # (n_rows, 128) int32 lane gather, host
    # masks and final_lane on the device of the plain version's first call
    # there, kept for its later calls (an upload per call would wait on
    # the stream); the kernel's path never makes them
    _stages: tuple = field(default=(), init=False, repr=False,
                           compare=False)


@dataclass(kw_only=True)
class DevicePR(DevicePRIndex):
    """One PR problem on a device with f32 values."""

    val: torch.Tensor         # (n_rows, 128) float32


@dataclass
class DevicePanelPR:
    """Row-slice panels (:class:`~..formats.pr.PanelPRMatrix`): one problem
    each (all :class:`DevicePR`, or all ``DevicePRDD``), sharing the x
    table(s); y is the concatenation of their sigma-order outputs."""

    nrows: int
    ncols: int
    nnz: int
    panels: list


def _ints(a, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.int32))).to(device)


def _check_bins(bins: tuple, n_rows: int, y_rows: int):
    """Bins must tile the problem's groups in order, and their slots the
    leading destination rows: then every y element is written once."""
    g_next, off_next = 0, 0
    for K, G, off, g0 in bins:
        if K < 1 or G < 1 or g0 != g_next or off != off_next:
            raise ValueError(f"PR bins do not tile the groups: {bins}")
        g_next, off_next = g0 + G, off + K * SUBLANES * G
    if g_next * SUBLANES != y_rows or off_next > n_rows:
        raise ValueError(f"PR bins {bins} do not cover {y_rows} y rows "
                         f"within {n_rows} Beneš rows")


def compose_route(masks: torch.Tensor, final_lane: torch.Tensor):
    """The Beneš stages and the final lane gather as one plane: run them on
    an iota of source slots, ``a[i] = bit_s(masks[i]) ? a[i ^ d_s] : a[i]``
    per stage, then ``a = take_along_axis(a, final_lane, 1)``."""
    n_rows = masks.shape[0]
    a = torch.arange(n_rows * LANES, dtype=torch.int32,
                     device=masks.device).view(n_rows, LANES)
    idx = torch.arange(n_rows, device=masks.device)
    for s, d in enumerate(benes_stage_distances(n_rows)):
        a = torch.where(((masks >> s) & 1) == 1, a[idx ^ d], a)
    return torch.gather(a, 1, final_lane.long()).contiguous()


def _put_index(pr, device) -> dict:
    """The :class:`DevicePRIndex` fields of host problem ``pr`` (this
    package's or the JAX package's ``PRMatrix``) on ``device``."""
    n_rows, y_rows = int(pr.n_rows), int(pr.y_rows)
    bins = tuple(tuple(int(v) for v in b) for b in pr.bins)
    _check_bins(bins, n_rows, y_rows)
    masks = np.ascontiguousarray(pr.masks, np.int32)
    final_lane = np.ascontiguousarray(pr.final_lane, np.int32)
    return dict(
        nrows=int(pr.nrows), ncols=int(pr.ncols), nnz=int(pr.nnz),
        n_rows=n_rows, y_rows=y_rows, bins=bins,
        bin_table=_ints(np.asarray(bins).reshape(-1, 4), device),
        md=_ints(pr.md, device), row_slab=_ints(pr.row_slab, device),
        route=compose_route(_ints(masks, device), _ints(final_lane, device)),
        max_slab=int(np.max(pr.row_slab)),
        masks=masks, final_lane=final_lane)


def _put_panels(pr, put) -> DevicePanelPR:
    return DevicePanelPR(int(pr.nrows), int(pr.ncols), int(pr.nnz),
                         [put(p) for p in pr.panels])


def device_put_pr(pr, dtype=torch.float32, *, device):
    """Upload a host ``PRMatrix`` (returns a :class:`DevicePR`) or
    ``PanelPRMatrix`` (a :class:`DevicePanelPR`), of this package or of the
    JAX package: only their attributes are read. Values are f32."""
    if dtype != torch.float32:
        raise ValueError(f"PR values are torch.float32, not {dtype}")
    if hasattr(pr, "panels"):
        return _put_panels(pr, lambda p: device_put_pr(p, dtype,
                                                       device=device))
    device = torch.device(device)
    return DevicePR(**_put_index(pr, device),
                    val=torch.from_numpy(np.ascontiguousarray(
                        pr.val, np.float64)).to(torch.float32).to(device))


# ---------------------------------------------------------------------------
# the plain version, step by step as the TPU kernel
# ---------------------------------------------------------------------------


def _x_gather(d: DevicePRIndex, x_tab: torch.Tensor) -> torch.Tensor:
    """x at each source slot: ``x[128*row_slab[r] + (md[r, l] & 127)]``."""
    rows = x_tab.view(-1, LANES)[d.row_slab.long()]
    return torch.gather(rows, 1, (d.md & (LANES - 1)).long())


def _route_planes(d: DevicePRIndex, planes: list) -> list:
    """Every plane through the exchange stages (``torch.where(bit, a[idx ^
    d], a)``) and the final lane gather, alike, on the planes' device."""
    device = planes[0].device
    if not d._stages or d._stages[0].device != device:
        d._stages = (_ints(d.masks, device),
                     _ints(d.final_lane, device).long())
    masks, fl = d._stages
    idx = torch.arange(d.n_rows, device=device)
    for s, dist in enumerate(benes_stage_distances(d.n_rows)):
        swap = ((masks >> s) & 1) == 1
        partner = idx ^ dist
        planes = [torch.where(swap, a[partner], a) for a in planes]
    return [torch.gather(a, 1, fl) for a in planes]


def _k_sum(blk: torch.Tensor) -> torch.Tensor:
    """Sum a bin's (G, K, 8, 128) slots over K as the TPU kernel does: a
    pairwise tree for K <= 16, in order beyond."""
    K = blk.shape[1]
    if K > _UNROLL_K:
        acc = blk[:, 0]
        for k in range(1, K):
            acc = acc + blk[:, k]
        return acc
    parts = [blk[:, k] for k in range(K)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def pr_problem_plain(d: DevicePR, x_tab: torch.Tensor) -> torch.Tensor:
    """One problem's y (``y_rows*128``, sigma order, uncropped): products
    ``val * x`` in column order, routed by the stages, summed per bin."""
    (a,) = _route_planes(d, [d.val * _x_gather(d, x_tab)])
    y = torch.zeros(d.y_rows, LANES, dtype=torch.float32, device=a.device)
    rows = y.view(-1, SUBLANES, LANES)
    for K, G, off, g0 in d.bins:
        rows[g0:g0 + G] = _k_sum(
            a[off:off + G * K * SUBLANES].view(G, K, SUBLANES, LANES))
    return y.view(-1)


# ---------------------------------------------------------------------------
# the wrapper: CUDA tensors launch the kernel, CPU tensors run the plain one
# ---------------------------------------------------------------------------


def _check_launch(d: DevicePRIndex, values: dict, xs: dict):
    """Check what a launch reads: every tensor on the device of the first
    x and contiguous, int32 index planes, f32 values and x, plane sizes that
    match the problem, and an x table that reaches its last slab."""
    x0 = next(iter(xs.values()))
    if x0.device.type != "cuda":
        raise RuntimeError(
            f"the PR kernel runs on CUDA or CPU tensors, not {x0.device}")
    ints = {"bin_table": d.bin_table, "md": d.md, "row_slab": d.row_slab,
            "route": d.route}
    for name, t in {**ints, **values, **xs}.items():
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in {**values, **xs}.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    plane = d.n_rows * LANES
    for name, t in {"md": d.md, "route": d.route, **values}.items():
        if t.numel() != plane:
            raise ValueError(f"{name} holds {t.numel()} slots, the problem "
                             f"{plane}")
    if d.row_slab.numel() != d.n_rows or d.bin_table.numel() != 4 * len(
            d.bins):
        raise ValueError("row_slab or the bin table does not match the "
                         "problem")
    need = LANES * d.max_slab + LANES
    if any(x.dim() != 1 or x.numel() < need for x in xs.values()):
        raise ValueError(f"x must be a 1-D table of at least {need} entries "
                         f"(x slab {d.max_slab})")
    if plane > 2**31 - 1 or d.y_rows * LANES > 2**31 - 1:
        raise ValueError("the problem is beyond 32-bit indexing")


def _launch(wrapper, d: DevicePRIndex, name: str, operands: tuple):
    """Call C entry ``name`` for problem ``d``: bin table, index planes,
    then ``operands`` (values, x, y; device pointers), the group count and
    the current stream; count the launch on ``wrapper``."""
    device = operands[0].device
    with torch.cuda.device(device):
        err = getattr(_build.load(), name)(
            d.bin_table.data_ptr(), len(d.bins), d.route.data_ptr(),
            d.md.data_ptr(), d.row_slab.data_ptr(),
            *(t.data_ptr() for t in operands), d.y_rows // SUBLANES,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1


def pr_problem(d: DevicePR, x_tab: torch.Tensor) -> torch.Tensor:
    """One problem's y (``y_rows*128`` f32, sigma order, uncropped) through
    the kernel on CUDA tensors, or the plain version on CPU tensors."""
    if x_tab.device.type == "cpu":
        return pr_problem_plain(d, x_tab)
    _check_launch(d, {"val": d.val}, {"x": x_tab})
    # the bins tile every group (_check_bins): each element is stored once
    y = torch.empty(d.y_rows * LANES, dtype=torch.float32,
                    device=x_tab.device)
    _launch(pr_problem, d, "pr_spmv_f32", (d.val, x_tab, y))
    return y


pr_problem.launches = 0


def _check_x_table(dpr, x_tab: torch.Tensor):
    n = slab_table_rows(dpr.ncols) * LANES
    if x_tab.dtype != torch.float32 or tuple(x_tab.shape) != (n,):
        raise ValueError(
            f"x must be the padded f32 table of device_put_x / pack_x_table "
            f"({n} entries for {dpr.ncols} columns), got {x_tab.dtype} "
            f"{tuple(x_tab.shape)}")


def _spmv(dpr, xs: tuple, run, crop: bool) -> tuple:
    """One y per x table through ``run(problem, *xs) -> ys``; panels crop
    each problem to its rows and concatenate."""
    if hasattr(dpr, "panels"):
        parts = [_spmv(p, xs, run, True) for p in dpr.panels]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(len(xs)))
    for x in xs:
        _check_x_table(dpr, x)
    ys = run(dpr, *xs)
    ys = ys if isinstance(ys, tuple) else (ys,)
    return tuple(y[: dpr.nrows] if crop else y for y in ys)


def _check_kind(dpr, problem, fn: str, hint: str = ""):
    """``dpr`` is a ``problem`` or a :class:`DevicePanelPR` of them."""
    parts = dpr.panels if isinstance(dpr, DevicePanelPR) else (dpr,)
    if not all(isinstance(p, problem) for p in parts):
        raise TypeError(f"{fn} takes a {problem.__name__} or a DevicePanelPR "
                        f"of them, got {type(dpr).__name__}{hint}")


def _check_f32(dpr):
    _check_kind(dpr, DevicePR, "pr_spmv", " (dd: pr_spmv_dd)")


def pr_spmv(dpr, x_tab: torch.Tensor, *, crop: bool = True) -> torch.Tensor:
    """``y = A @ x`` over the PR layout, in sigma row order (f32).

    ``x_tab`` is x padded by :func:`~.sell.device_put_x` or
    :func:`~.sell.pack_x_table`. A single problem returns ``y[:nrows]``
    (``crop=False``: all ``y_rows*128``); panels concatenate their cropped
    outputs, as ``PanelPRMatrix.row_perm`` orders them."""
    _check_f32(dpr)
    return _spmv(dpr, (x_tab,), pr_problem, crop)[0]


def pr_spmv_plain(dpr, x_tab: torch.Tensor, *,
                  crop: bool = True) -> torch.Tensor:
    """:func:`pr_spmv` through the plain version on any device."""
    _check_f32(dpr)
    return _spmv(dpr, (x_tab,), pr_problem_plain, crop)[0]
