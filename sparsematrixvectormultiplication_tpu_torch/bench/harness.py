"""Benchmark harness — stage runner with validation (≙ main.c / main_cuda.cu).

Per matrix: convert to CSR and SELL, run each stage, validate every stage
against the serial fp64 CSR oracle (≙ main.c:145,207,260,310,362) and report
median time and GFLOPS = 2·nnz/t. Stages:

* ``serial_csr`` — the host fp64 oracle itself;
* ``sell`` — f32 values on ``device``;
* ``sell_bf16`` — bf16 values, x and sums in f32, validated against the fp64
  SpMV of the bf16-quantized matrix, so the check isolates the kernels from
  the storage rounding.

A stage that fails raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..formats.coo import COOMatrix
from ..formats.csr import CSRMatrix
from ..formats.sell import SellMatrix
from ..ops.sell import device_put_sell, device_put_x, sell_spmv
from ..utils.metrics import calculate_flops
from ..utils.timing import ITERATION_SKIP, time_fn
from ..utils.validation import DiffMetrics, difference_metrics

__all__ = ["BenchConfig", "StageResult", "MatrixResult", "run_matrix",
           "quantize_bf16"]


@dataclass
class BenchConfig:
    iterations: int = 20          # measured reps; the median is reported
    skip: int = ITERATION_SKIP    # warm-up calls (≙ utility.h:7)


@dataclass
class StageResult:
    stage: str
    seconds: float
    gflops: float
    diff: DiffMetrics


@dataclass
class MatrixResult:
    name: str
    nrows: int
    ncols: int
    nnz: int
    stages: dict            # stage -> StageResult
    format_stats: dict
    config: BenchConfig
    sell: SellMatrix  # the host SELL the device stages ran


def quantize_bf16(values: np.ndarray) -> np.ndarray:
    """fp64 copy of ``values`` rounded to bf16 exactly as the device upload
    rounds them."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        torch.bfloat16).to(torch.float64).numpy()


def run_matrix(
    name: str,
    coo: COOMatrix,
    cfg: BenchConfig = BenchConfig(),
    x: np.ndarray | None = None,
    log=print,
    *,
    device,
) -> MatrixResult:
    """Run the three stages on one matrix (≙ the per-matrix body of
    main.c:39-459 / main_cuda.cu:52-729). SELL bins take the "auto" layout,
    rebuilt with SELL-sigma row order when the plain conversion is
    pathological; differences count at the default tolerances of
    ``difference_metrics``."""
    device = torch.device(device)
    M, N, nnz = coo.nrows, coo.ncols, coo.nnz
    if x is None:
        x = np.ones(N, dtype=np.float64)  # ≙ init_vector_at_one (utility.c:18)

    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(coo)
    fstats = {"csr": csr.memory_stats(),
              "convert_csr_s": time.perf_counter() - t0}
    stages: dict = {}

    # --- golden oracle: host fp64 serial CSR (≙ csr_matrix_vector_mult) ---
    times = []
    for _ in range(min(cfg.skip, 2) + 3):
        t0 = time.perf_counter()
        y_ref = csr.spmv(x)
        times.append(time.perf_counter() - t0)
    sec = min(times)
    stages["serial_csr"] = StageResult(
        "serial_csr", sec, calculate_flops(nnz, sec) / 1e9, DiffMetrics())
    log(f"[{name}] serial_csr: {sec*1e3:.3f} ms = "
        f"{stages['serial_csr'].gflops:.3f} GFLOPS (host fp64 oracle)")

    # ultra-heavy rows split into <=cap-entry segments; the segments' sums
    # are reduced back to rows with index_add_ (classic row splitting). Short-
    # row matrices split finer, strided, as the JAX harness does
    # (formats/csr.py split_heavy_rows)
    med_nnz = float(np.median(csr.row_nnz())) if M else 0.0
    split_cap = 16 if med_nnz <= 24 else 256
    csr_k, seg_map = csr.split_heavy_rows(split_cap, strided=split_cap < 256)
    if seg_map is not None:
        fstats["heavy_row_segments"] = int(csr_k.nrows - M)
        log(f"[{name}] split {csr_k.nrows - M} heavy-row segments "
            f"(rows {M} -> {csr_k.nrows})")

    t0 = time.perf_counter()
    sell = SellMatrix.from_csr(csr_k)
    # pathological plain conversions (power-law heads: bins with k > 1024
    # or padding above 8x) fall back to SELL-sigma row sorting, as the JAX
    # harness's build_sell does
    if any(b.k > 1024 for b in sell.bins) or sell.padding_ratio > 8:
        log(f"[{name}] plain SELL pathological "
            f"(pad {sell.padding_ratio:.1f}, kmax "
            f"{max((b.k for b in sell.bins), default=0)}) -> auto sigma")
        sell = SellMatrix.from_csr(csr_k, sigma_sort=True)
    fstats["convert_sell_s"] = time.perf_counter() - t0

    # kernel output slot -> original row: the sigma permutation picks the
    # segment, the segment map its row
    ids = None
    if seg_map is not None or sell.row_perm is not None:
        ids = seg_map if seg_map is not None else np.arange(csr_k.nrows)
        if sell.row_perm is not None:
            ids = np.asarray(ids)[sell.row_perm]
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(device)

    def spmv_rows(d, xt):
        y = sell_spmv(d, xt)
        if ids is not None:
            y = torch.zeros(M, dtype=y.dtype, device=device).index_add_(
                0, ids, y)
        return y
    fstats["sell"] = sell.memory_stats()
    xt = device_put_x(x, N, device=device)

    def run_stage(stage, dtype, ref):
        d = device_put_sell(sell, dtype, device=device)
        y = spmv_rows(d, xt).cpu().numpy()
        dm = difference_metrics(ref, y.astype(np.float64))
        # the timed call is the SpMV itself; the segment reduction is an
        # epilogue the JAX harness also keeps out of the timed path
        sec = time_fn(sell_spmv, d, xt, device=device, reps=cfg.iterations,
                      skip=cfg.skip)
        stages[stage] = StageResult(stage, sec,
                                    calculate_flops(nnz, sec) / 1e9, dm)
        log(f"[{name}] {stage}: {sec*1e3:.3f} ms = "
            f"{stages[stage].gflops:.3f} GFLOPS on {device}, "
            f"sig_diffs={dm.significant_diffs}, max_rel={dm.max_rel_err:.2e}")

    run_stage("sell", torch.float32, y_ref)
    csr_q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                      quantize_bf16(csr.values))
    run_stage("sell_bf16", torch.bfloat16, csr_q.spmv(x))

    return MatrixResult(name, M, N, nnz, stages, fstats, cfg, sell)
