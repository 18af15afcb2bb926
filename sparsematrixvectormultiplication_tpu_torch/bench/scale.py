"""Scaling-axis sweeps: the K-bin ladder, the launch-configuration axis
(finer bins = less padding, more kernel launches); one native-schema row per
ladder (≙ the reference's logged block-size choices,
cuda_src/utility.cu:236).

The JAX package's device-count sweeps (``run_path_scale_sweep``,
``run_device_scale_sweep``, ``run_spmm_device_scale_sweep``) need the
multi-device layer and come with it.
"""

# Ported from sparsematrixvectormultiplication_tpu/bench/scale.py (the port
# must not import the JAX package).

from __future__ import annotations

import time

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.sell import SellMatrix
from ..ops.sell import (device_put_sell, device_put_x, sell_spmv,
                        sell_spmv_launches)
from ..tune.autotune import DEFAULT_LADDERS
from ..utils.metrics import calculate_flops
from ..utils.timing import MAX_QUEUED_LAUNCHES, device_time_fn, time_fn
from ..utils.validation import difference_metrics
from .csv_report import NATIVE_HEADER, _append_row, _fmt, _stream_columns
from .harness import DTYPES, device_bytes, quantize_bf16

__all__ = ["run_ladder_sweep"]


def run_ladder_sweep(
    name: str,
    csr: CSRMatrix,
    out_csv: str,
    *,
    dtype=torch.float32,
    iterations: int = 32,
    rounds: int = 2,
    x: np.ndarray | None = None,
    log=print,
    device="cuda",
):
    """Time ``sell`` under each K-bin ladder of ``DEFAULT_LADDERS`` on
    ``device``; append one native-schema row per ladder to ``out_csv`` with
    stage ``sell@<ladder>``, the bytes of the tensors the SpMV ran on and,
    on a CUDA device, their share of the card's copy rate. Returns
    ``[(ladder, seconds, gflops, DiffMetrics)]``.

    The time is the best of ``rounds`` device times of ``iterations`` calls
    back to back (the CPU: host medians). A ladder whose conversion raises
    ``ValueError`` or ``MemoryError`` costs its row; a launch error raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ladder_sweep times on a CUDA device and none "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    if x is None:
        x = np.ones(csr.ncols, dtype=np.float64)
    y_ref = csr.spmv(x)
    if dtype == torch.bfloat16:  # the oracle of the bf16-rounded values
        y_ref = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                          quantize_bf16(csr.values)).spmv(x)
    xt = device_put_x(x, csr.ncols, device=device)
    dt_name = {v: k for k, v in DTYPES.items()}[dtype]
    arith = {"float32": "fp32", "bfloat16": "bf16"}[dt_name]

    # the harness's heavy-row split: rows past the cap would make K > 1024
    # bins, which the JAX sweep once fed the kernels unsplit
    nrows_nat = csr.nrows
    med_nnz = float(np.median(csr.row_nnz())) if nrows_nat else 0.0
    split_cap = 16 if med_nnz <= 24 else 256
    csr, seg_map = csr.split_heavy_rows(split_cap, strided=split_cap < 256)
    if seg_map is not None:
        log(f"[{name}] ladders: split heavy rows {nrows_nat} -> {csr.nrows} "
            f"(cap {split_cap})")

    def _to_natural(y_k):
        if seg_map is None:
            return y_k[:nrows_nat]
        return np.bincount(np.asarray(seg_map), weights=y_k,
                           minlength=nrows_nat)[:nrows_nat]

    def _seconds(dsell):
        if device.type == "cuda":
            reps = max(1, min(iterations,
                              MAX_QUEUED_LAUNCHES
                              // sell_spmv_launches(dsell)))
            return min(device_time_fn(sell_spmv, dsell, xt, device=device,
                                      reps=reps) for _ in range(rounds))
        return min(time_fn(sell_spmv, dsell, xt, device=device,
                           reps=iterations) for _ in range(rounds))

    out = []
    for ladder, k_bins in DEFAULT_LADDERS.items():
        t0 = time.perf_counter()
        try:
            sell = SellMatrix.from_csr(csr, k_bins=k_bins)
        except (ValueError, MemoryError) as e:
            log(f"[{name}] ladder {ladder}: conversion refused: "
                f"{type(e).__name__}: {str(e)[:300]}")
            continue
        conv_s = time.perf_counter() - t0
        dsell = device_put_sell(sell, dtype, device=device)
        y = sell_spmv(dsell, xt)
        nbytes = device_bytes(dsell, xt, y)
        y = y.cpu().numpy().astype(np.float64)
        dm = difference_metrics(y_ref, _to_natural(y[: csr.nrows]))
        sec = _seconds(dsell)
        gf = calculate_flops(csr.nnz, sec) / 1e9
        log(f"[{name}] sell@{ladder}: {sec*1e3:.4f} ms = {gf:.3f} GFLOPS "
            f"on {device} (pad {sell.padding_ratio:.2f}, {len(sell.bins)} "
            f"bins, {nbytes} B, sig_diffs={dm.significant_diffs}; "
            f"conversion {conv_s:.1f} s)")
        per_nnz, pct = _stream_columns(nbytes, csr.nnz, sec,
                                       device.type == "cuda")
        _append_row(
            out_csv, NATIVE_HEADER,
            [name, nrows_nat, csr.ncols, csr.nnz, f"sell@{ladder}",
             dt_name, arith, _fmt(sec), f"{gf:.6f}", "",
             f"{dm.mean_rel_err:.15e}", dm.significant_diffs,
             f"{dm.max_abs_err:.15e}", f"{dm.max_rel_err:.15e}",
             f"{sell.padding_ratio:.6f}", per_nnz, pct],
        )
        out.append((ladder, sec, gf, dm))
        del sell, dsell
    return out
