"""Automatic format selection — the one-call user surface.

Counterpart of the JAX package's ``ops/auto.py``. Three layouts have
disjoint winning regimes:

* ``sell``  — banded / clustered / moderate-locality matrices;
* ``split`` — band + scattered tail (road/circuit class): near SELL plus a
  natural-order PR far side;
* ``pr``    — zero/low locality (power-law webs, uniform random).

:func:`choose_format` is a copy of the JAX package's host-side profile rules
(their thresholds were chosen on the TPU and are kept as they are, so both
packages pick the same layout); :func:`auto_device_op` converts, uploads to
``device`` and returns an :class:`AutoOp` whose ``matvec`` takes and returns
numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.split import _MAX_FAR_FRAC, split_stats

__all__ = ["choose_format", "auto_device_op", "AutoOp"]

# beyond this many distinct (group, slab) pairs per entry the broadcast-
# scan kernels pay >= ~1 vector-op per pair (the diffuse floor,
# docs/DESIGN.md round-3) and PR wins
_PR_SLABS_PER_ENTRY = 0.02


def choose_format(csr: CSRMatrix) -> tuple:
    """Returns ``(kind, stats)`` with kind in {"sell", "split", "pr"}."""
    if csr.nnz == 0:
        return "sell", {"reason": "empty matrix"}
    st1 = split_stats(csr, 1)
    ng = max(-(-csr.nrows // 1024), 1)
    slabs_per_entry = st1["gslabs_all"] * ng / csr.nnz
    # band + tail: removing the tail collapses the per-group slab count
    for d in (1, 2, 4, 8, 16, 32):
        st = split_stats(csr, d) if d != 1 else st1
        if (st["far_frac"] <= _MAX_FAR_FRAC
                and st["gslabs_near"] <= 0.5 * st["gslabs_all"]
                and st["far_frac"] > 0.005):
            return "split", {**st, "reason": "band + scattered tail"}
        if st["far_frac"] <= 0.005:
            break  # already (near-)pure band at this threshold
    if slabs_per_entry > _PR_SLABS_PER_ENTRY:
        return "pr", {"slabs_per_entry": slabs_per_entry,
                      "reason": "zero/low locality (diffuse floor)"}
    return "sell", {"slabs_per_entry": slabs_per_entry,
                    "reason": "banded/clustered locality"}


@dataclass
class AutoOp:
    """An uploaded SpMV operator. ``matvec(x)`` takes and returns numpy
    arrays (the host round trip included); ``kind`` says which layout won,
    ``matrix`` is the device structure, ``host`` the host conversion product
    (its ``.spmv`` is the fp64 oracle twin)."""

    kind: str
    stats: dict
    nrows: int
    ncols: int
    matrix: object
    host: object
    device: torch.device
    row_perm: np.ndarray | None = None  # pr: kernel output is sigma order
    seg_ids: np.ndarray | None = None   # pr after a heavy-row split: kernel
                                        # row -> original row (host reduce)

    def matvec(self, x) -> np.ndarray:
        from .sell import device_put_x

        xt = device_put_x(np.asarray(x, np.float64), self.ncols,
                          device=self.device)
        y = self._call(xt).cpu().numpy().astype(np.float64)
        if self.seg_ids is not None:  # heavy-split segments, host-exact
            return np.bincount(self.seg_ids, weights=y,
                               minlength=self.nrows)[: self.nrows]
        if self.row_perm is not None:
            # a PanelPRMatrix skips all-zero sigma-tail rows: they stay 0
            out = np.zeros(self.nrows, np.float64)
            out[self.row_perm] = y[: self.row_perm.size]
            return out
        return y[: self.nrows]

    def _call(self, xt):
        if self.kind == "sell":
            from .sell import sell_spmv
            return sell_spmv(self.matrix, xt)
        if self.kind == "split":
            from .split import split_spmv
            return split_spmv(self.matrix, xt)
        from .pr import pr_spmv
        return pr_spmv(self.matrix, xt)


def auto_device_op(csr: CSRMatrix, dtype=torch.float32, *, device,
                   log=None) -> AutoOp:
    """Profile -> convert -> upload -> callable op, in one call."""
    device = torch.device(device)
    kind, stats = choose_format(csr)
    if log:
        log(f"auto_device_op: {kind} ({stats.get('reason')})")
    row_perm = None
    seg_ids = None
    if kind == "split":
        from ..formats.split import SplitMatrix
        from .split import device_put_split

        host = SplitMatrix.from_csr(csr)
        dev = device_put_split(host, dtype, device=device)
    elif kind == "pr":
        from ..formats.pr import pr_from_csr
        from .pr import device_put_pr

        try:
            host = pr_from_csr(csr)
            row_perm = host.row_perm
        except ValueError:
            # dense rows force k*8 Beneš dest rows each — split them into
            # strided segments first (the harness's own recipe) and reduce
            # host-side in matvec
            csr_k, seg = csr.split_heavy_rows(16, strided=True)
            host = pr_from_csr(csr_k)
            seg_ids = np.asarray(seg)[host.row_perm]
        dev = device_put_pr(host, dtype, device=device)
    else:
        from ..formats.sell import SellMatrix
        from .sell import device_put_sell

        host = SellMatrix.from_csr(csr)
        dev = device_put_sell(host, dtype, device=device)
    return AutoOp(kind=kind, stats=stats, nrows=csr.nrows, ncols=csr.ncols,
                  matrix=dev, host=host, device=device, row_perm=row_perm,
                  seg_ids=seg_ids)
