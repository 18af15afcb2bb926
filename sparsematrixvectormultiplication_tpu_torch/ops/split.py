"""The locality-split composite on a device: near SELL plus a PR far side.

Counterpart of the JAX package's ``ops/pallas_split.py``; a composition with
no kernel of its own. A host :class:`~..formats.split.SplitMatrix` holds the
band (and every row's overflow far entries) as a SELL matrix in natural row
order, and each row's first far entry as a PR problem in which every row
holds exactly one entry, so its sigma order is the identity: the two y
combine by one vector add (f32), or one ``dd_add_dd`` (double-double).
Both read the same padded x table(s); the near side runs the SELL kernels
of :mod:`.sell` / :mod:`.sell_dd`, the far side the PR kernels of
:mod:`.pr` / :mod:`.pr_dd`.

The JAX dd upload refuses far problems beyond 2^14 Beneš rows, a TPU VMEM
bound; the port has no such guard (the host ``SplitMatrix`` still builds its
far side to 2^14-row problems).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .doubledouble import dd_add_dd
from .pr import device_put_pr, pr_spmv, pr_spmv_plain
from .pr_dd import device_put_pr_dd, pr_spmv_dd, pr_spmv_dd_plain
from .sell import device_put_sell, sell_spmv, sell_spmv_plain
from .sell_dd import device_put_sell_dd, sell_spmv_dd, sell_spmv_dd_plain

__all__ = ["DeviceSplit", "DeviceSplitDD", "device_put_split",
           "device_put_split_dd", "split_spmv", "split_spmv_plain",
           "split_spmv_dd", "split_spmv_dd_plain"]


@dataclass
class DeviceSplit:
    nrows: int
    ncols: int
    nnz: int
    near: object   # DeviceSell
    far: object    # DevicePR | DevicePanelPR


@dataclass
class DeviceSplitDD:
    nrows: int
    ncols: int
    nnz: int
    near: object   # DeviceSellDD
    far: object    # DevicePRDD | DevicePanelPR of them


def _check_natural(sm):
    if getattr(sm.near, "row_perm", None) is not None:
        raise ValueError("the split's near SELL must keep natural row order "
                         "(built without sigma_sort)")


def device_put_split(sm, dtype=torch.float32, *, device) -> DeviceSplit:
    """Upload a host ``SplitMatrix`` (this package's or the JAX package's):
    the near SELL and the far PR side with ``dtype`` values (f32 or
    bf16)."""
    _check_natural(sm)
    return DeviceSplit(int(sm.nrows), int(sm.ncols), int(sm.nnz),
                       device_put_sell(sm.near, dtype, device=device),
                       device_put_pr(sm.far, dtype, device=device))


def device_put_split_dd(sm, *, device) -> DeviceSplitDD:
    """Upload a host ``SplitMatrix`` with (hi, lo) value planes on both
    sides (the near SELL must have no slot-packed sg bins)."""
    _check_natural(sm)
    return DeviceSplitDD(int(sm.nrows), int(sm.ncols), int(sm.nnz),
                         device_put_sell_dd(sm.near, device=device),
                         device_put_pr_dd(sm.far, device=device))


def _split(ds, x_tab, near, far) -> torch.Tensor:
    if not isinstance(ds, DeviceSplit):
        raise TypeError(f"split_spmv takes a DeviceSplit, got "
                        f"{type(ds).__name__} (dd: split_spmv_dd)")
    return near(ds.near, x_tab) + far(ds.far, x_tab)[: ds.nrows]


def split_spmv(ds: DeviceSplit, x_tab: torch.Tensor) -> torch.Tensor:
    """``y = near_sell(x) + far_pr(x)``, both in natural row order; ``x_tab``
    is x padded by :func:`~.sell.device_put_x`."""
    return _split(ds, x_tab, sell_spmv, pr_spmv)


def split_spmv_plain(ds: DeviceSplit, x_tab: torch.Tensor) -> torch.Tensor:
    """:func:`split_spmv` through the plain versions on any device."""
    return _split(ds, x_tab, sell_spmv_plain, pr_spmv_plain)


def _split_dd(ds, xh, xl, near, far):
    if not isinstance(ds, DeviceSplitDD):
        raise TypeError(f"split_spmv_dd takes a DeviceSplitDD, got "
                        f"{type(ds).__name__}")
    yh_n, yl_n = near(ds.near, xh, xl)
    yh_f, yl_f = far(ds.far, xh, xl)
    return dd_add_dd(yh_n, yl_n, yh_f[: ds.nrows], yl_f[: ds.nrows])


def split_spmv_dd(ds: DeviceSplitDD, xh_tab: torch.Tensor,
                  xl_tab: torch.Tensor):
    """``(yh, yl) = near_dd(x) ⊕ far_dd(x)``, both natural row order, joined
    by an error-free ``dd_add_dd``; the x halves padded by
    :func:`~.sell_dd.device_put_x_dd`."""
    return _split_dd(ds, xh_tab, xl_tab, sell_spmv_dd, pr_spmv_dd)


def split_spmv_dd_plain(ds: DeviceSplitDD, xh_tab: torch.Tensor,
                        xl_tab: torch.Tensor):
    """:func:`split_spmv_dd` through the plain versions on any device."""
    return _split_dd(ds, xh_tab, xl_tab, sell_spmv_dd_plain, pr_spmv_dd_plain)
