"""Double-double PR SpMV in PyTorch: fp64-class results on zero-locality
matrices.

Counterpart of the JAX package's ``ops/pallas_pr_dd.py`` (``_kernel_pr_dd``
-> ``csrc/pr.cu`` ``pr_spmv_dd``). The problem's index side (planes, bins,
the destination-order ``dst_col``) is :mod:`.pr`'s; the values travel as
f32 (hi, lo) planes (``split_f64`` of the fp64 host values), in source
order for the plain version and, for the kernel, as one destination-order
plane of interleaved (hi, lo) pairs (8 B a slot, one load), and x as a
pair of padded tables. Each product is an error-free two-product plus the
cross terms, both planes ride the same routing, and each row's K slots are
summed by a chain of ``dd_add_dd`` from (0, 0). y comes back as a pair in sigma row
order, which :func:`~.doubledouble.combine_f64` joins in fp64.

:func:`pr_problem_dd` is the kernel's wrapper (``.launches``): CUDA tensors
launch the kernel or raise, CPU tensors run :func:`pr_problem_plain_dd`,
which repeats the TPU kernel step by step. The TPU kernel's 2^14-row guard
and upload cap are VMEM limits and are not carried over;
:data:`DD_PANEL_TARGET_ROWS` is kept only as the host conversion's cap, with
which ``run_matrix`` decides whether the f32 conversion serves dd too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.sell import LANES, SUBLANES
from .doubledouble import dd_add_dd, split_f64, two_prod
from .pr import (DevicePRIndex, _check_kind, _check_launch, _launch,
                 _put_index, _put_panels, _route_planes, _routed, _spmv,
                 _x_gather)

__all__ = ["DevicePRDD", "device_put_pr_dd",
           "pr_problem_dd", "pr_problem_plain_dd", "pr_spmv_dd",
           "pr_spmv_dd_plain", "DD_PANEL_TARGET_ROWS"]

DD_PANEL_TARGET_ROWS = 1 << 14   # the JAX dd kernel's per-problem cap


@dataclass(kw_only=True)
class DevicePRDD(DevicePRIndex):
    """One PR problem on a device with its fp64 values split into two f32
    planes (see :class:`~.pr.DevicePRIndex` for the index side)."""

    val_h: torch.Tensor   # (n_rows, 128) float32
    val_l: torch.Tensor   # (n_rows, 128) float32
    dst_val: torch.Tensor  # (dst_rows, 128, 2) float32 (hi, lo) at route


def device_put_pr_dd(pr, *, device):
    """Upload a host ``PRMatrix`` / ``PanelPRMatrix`` (this package's or the
    JAX package's) with its values split into f32 (hi, lo) planes; panels
    come back as a :class:`~.pr.DevicePanelPR` of :class:`DevicePRDD`."""
    if hasattr(pr, "panels"):
        return _put_panels(pr, lambda p: device_put_pr_dd(p, device=device))
    device = torch.device(device)
    index, route = _put_index(pr, device)
    hi, lo = (torch.from_numpy(v).to(device)
              for v in split_f64(np.asarray(pr.val, np.float64)))
    return DevicePRDD(**index, val_h=hi, val_l=lo,
                      dst_val=_routed(torch.stack([hi, lo], -1), route))


def pr_problem_plain_dd(d: DevicePRDD, xh_tab: torch.Tensor,
                        xl_tab: torch.Tensor):
    """One problem's (yh, yl) (``y_rows*128`` each, sigma order, uncropped),
    step by step as ``_kernel_pr_dd``: ``ph, pe = two_prod(vh, xh)``, ``pl =
    pe + (vh*xl + vl*xh)``, both planes routed alike, then per row a
    ``dd_add_dd`` chain from (0, 0) over its K slots."""
    gh, gl = _x_gather(d, xh_tab), _x_gather(d, xl_tab)
    ph, pe = two_prod(d.val_h, gh)
    pl = pe + (d.val_h * gl + d.val_l * gh)
    rh, rl = _route_planes(d, [ph, pl])
    yh = torch.zeros(d.y_rows, LANES, dtype=torch.float32, device=rh.device)
    yl = torch.zeros_like(yh)
    for K, G, off, g0 in d.bins:
        bh = rh[off:off + G * K * SUBLANES].view(G, K, SUBLANES, LANES)
        bl = rl[off:off + G * K * SUBLANES].view(G, K, SUBLANES, LANES)
        h = torch.zeros(G, SUBLANES, LANES, dtype=torch.float32,
                        device=rh.device)
        l = torch.zeros_like(h)
        for k in range(K):
            h, l = dd_add_dd(h, l, bh[:, k], bl[:, k])
        yh.view(-1, SUBLANES, LANES)[g0:g0 + G] = h
        yl.view(-1, SUBLANES, LANES)[g0:g0 + G] = l
    return yh.view(-1), yl.view(-1)


def pr_problem_dd(d: DevicePRDD, xh_tab: torch.Tensor, xl_tab: torch.Tensor):
    """One problem's (yh, yl) through the dd kernel on CUDA tensors, or the
    plain dd version on CPU tensors."""
    if xh_tab.device.type == "cpu":
        return pr_problem_plain_dd(d, xh_tab, xl_tab)
    _check_launch(d, {"val_h": d.val_h, "val_l": d.val_l},
                  {"dst_val": d.dst_val}, {"x_hi": xh_tab, "x_lo": xl_tab},
                  pairs=True)
    # the bins tile every group: each element is stored once
    yh, yl = (torch.empty(d.y_rows * LANES, dtype=torch.float32,
                          device=xh_tab.device) for _ in range(2))
    _launch(pr_problem_dd, d, "pr_spmv_dd",
            (d.dst_val, xh_tab, xl_tab, yh, yl))
    return yh, yl


pr_problem_dd.launches = 0


def _check_dd(dpr):
    _check_kind(dpr, DevicePRDD, "pr_spmv_dd")


def pr_spmv_dd(dpr, xh_tab: torch.Tensor, xl_tab: torch.Tensor, *,
               crop: bool = True):
    """``y = A @ x`` in double-double over the PR layout; returns ``(yh,
    yl)`` in sigma row order, each ``[:nrows]`` (panels concatenated).
    ``xh_tab``/``xl_tab`` are x's halves padded by
    :func:`~.sell_dd.device_put_x_dd` or :func:`~.sell.pack_x_table`."""
    _check_dd(dpr)
    return _spmv(dpr, (xh_tab, xl_tab), pr_problem_dd, crop)


def pr_spmv_dd_plain(dpr, xh_tab: torch.Tensor, xl_tab: torch.Tensor, *,
                     crop: bool = True):
    """:func:`pr_spmv_dd` through the plain dd version on any device."""
    _check_dd(dpr)
    return _spmv(dpr, (xh_tab, xl_tab), pr_problem_plain_dd, crop)
