"""Benchmark harness — stage runner with validation (≙ main.c / main_cuda.cu).

Per matrix: convert to CSR, then run the configured stages, validate every
stage against the serial fp64 CSR oracle (≙ main.c:145,207,260,310,362) and
report median time and GFLOPS = 2·nnz/t. Stages:

* ``serial_csr`` — the host fp64 oracle itself; always runs;
* ``sell`` — SELL "auto", f32 values on ``device``;
* ``sell_bf16`` — bf16 values, x and sums in f32, validated against the fp64
  SpMV of the bf16-quantized matrix, so the check isolates the kernels from
  the storage rounding;
* ``sell_dd`` — fp64-class double-double (≙ the JAX harness's
  ``pallas_sell_dd``): values and x split into f32 (hi, lo) pairs, y
  combined and segment-summed in fp64 and validated against the fp64
  oracle. The dd kernels refuse slot-packed sg bins, so a SELL that has
  them is rebuilt in rows mode for this stage (``convert_sell_dd_s``);
* ``pr`` / ``pr_dd`` — the PR permutation-routed layout, f32 and dd
  (≙ ``pallas_pr`` / ``pallas_pr_dd``), built from the heavy-row-split CSR
  with ``target_rows=PANEL_TARGET_ROWS``; ``pr_dd`` reuses the f32
  conversion when every problem is within the dd cap. Their y is in sigma
  order and goes back to rows through ``unpermute`` or, after a heavy-row
  split, ``seg_map[pr.row_perm]`` and an fp64 ``np.bincount``;
* ``split`` / ``split_dd`` — the locality split (near SELL + PR far side,
  ≙ ``pallas_split`` / ``pallas_split_dd``). A matrix with no profitable
  near threshold (``SplitMatrix.from_csr`` raises ``ValueError``) records
  the stage as skipped, with the reason, in ``MatrixResult.skipped``;
* ``sell_spmm`` — multi-RHS SELL SpMM (≙ ``pallas_sell_spmm``) with
  ``BenchConfig.sell_spmm_rhs`` right-hand sides over a SELL forced to
  k-major, built from the heavy-row-split CSR; the segments' rows are
  reduced onto their rows with ``index_add_``;
* ``bsr_spmm`` — 128x128 block-sparse SpMM (≙ ``pallas_bsr_spmm``) with
  ``BenchConfig.spmm_rhs`` right-hand sides, on the original rows, route
  "blockspec". A matrix whose blocks exceed ``BSRMatrix.from_csr``'s byte
  budget records the stage as skipped, with the reason.

Both SpMM stages draw X from ``default_rng(0)`` in f32, validate a few
sampled columns against the fp64 oracle (``sampled_spmm_metrics``) and
report GFLOPS = 2·nnz·R/t.

Every stage records its norm-scaled error ``max|y - y_ref| / max|y_ref|``
(SpMM: over the sampled columns). Any other failure of a stage raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.bsr import BSRMatrix
from ..formats.coo import COOMatrix
from ..formats.csr import CSRMatrix
from ..formats.pr import PANEL_TARGET_ROWS, max_pr_rows, pr_from_csr
from ..formats.sell import SellMatrix
from ..formats.split import SplitMatrix
from ..ops.bsr import bsr_spmm, device_put_bsr, pad_rhs
from ..ops.doubledouble import combine_f64
from ..ops.pr import device_put_pr, pr_spmv
from ..ops.pr_dd import DD_PANEL_TARGET_ROWS, device_put_pr_dd, pr_spmv_dd
from ..ops.sell import device_put_sell, device_put_x, sell_spmv
from ..ops.sell_dd import device_put_sell_dd, device_put_x_dd, sell_spmv_dd
from ..ops.sell_spmm import device_put_x_multi, sell_spmm
from ..ops.split import (device_put_split, device_put_split_dd, split_spmv,
                         split_spmv_dd)
from ..utils.metrics import calculate_flops
from ..utils.timing import ITERATION_SKIP, time_fn
from ..utils.validation import (DiffMetrics, difference_metrics,
                                sampled_spmm_metrics)

__all__ = ["BenchConfig", "StageResult", "MatrixResult", "run_matrix",
           "quantize_bf16", "STAGES"]

STAGES = ("sell", "sell_bf16", "sell_dd", "pr", "pr_dd", "split", "split_dd",
          "sell_spmm", "bsr_spmm")
_SELL_STAGES = ("sell", "sell_bf16", "sell_dd")


@dataclass
class BenchConfig:
    iterations: int = 20          # measured reps; the median is reported
    skip: int = ITERATION_SKIP    # warm-up calls (≙ utility.h:7)
    stages: tuple = _SELL_STAGES  # device stages, in STAGES order
    sell_spmm_rhs: int = 16       # R of the sell_spmm stage (<= MAX_RHS)
    spmm_rhs: int = 128           # B of the bsr_spmm stage


@dataclass
class StageResult:
    stage: str
    seconds: float
    gflops: float
    diff: DiffMetrics
    norm_err: float = 0.0   # max|y - y_ref| / max|y_ref|
    rhs: int = 1            # right-hand sides per call (GFLOPS counts all)


@dataclass
class MatrixResult:
    name: str
    nrows: int
    ncols: int
    nnz: int
    stages: dict            # stage -> StageResult
    format_stats: dict
    config: BenchConfig
    csr: CSRMatrix | None = None       # the matrix the fp64 oracle ran
    sell: SellMatrix | None = None     # the host SELL sell/sell_bf16 ran
    sell_dd: SellMatrix | None = None  # the one sell_dd ran (rows mode
                                       # where sell has slot-packed sg bins)
    pr: object = None       # PRMatrix | PanelPRMatrix the pr stage ran
    split: object = None    # SplitMatrix the split stage ran
    sell_spmm: SellMatrix | None = None  # the k-major SELL sell_spmm ran
    bsr: BSRMatrix | None = None         # the blocks bsr_spmm ran
    skipped: dict = field(default_factory=dict)  # stage -> reason


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
    """Run ``serial_csr`` and ``cfg.stages`` on one matrix (≙ the per-matrix
    body of main.c:39-459 / main_cuda.cu:52-729). SELL bins take the "auto"
    layout, rebuilt with SELL-sigma row order when the plain conversion is
    pathological; differences count at the default tolerances of
    ``difference_metrics``."""
    unknown = [s for s in cfg.stages if s not in STAGES]
    if unknown:
        raise ValueError(f"unknown stages {unknown}; the port runs {STAGES}")
    device = torch.device(device)
    M, N, nnz = coo.nrows, coo.ncols, coo.nnz
    if x is None:
        x = np.ones(N, dtype=np.float64)  # ≙ init_vector_at_one (utility.c:18)

    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(coo)
    fstats = {"csr": csr.memory_stats(),
              "convert_csr_s": time.perf_counter() - t0}
    stages: dict = {}
    res = MatrixResult(name, M, N, nnz, stages, fstats, cfg, csr=csr)

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
    # are reduced back to rows (classic row splitting). Short-row matrices
    # split finer, strided, as the JAX harness does
    # (formats/csr.py split_heavy_rows)
    med_nnz = float(np.median(csr.row_nnz())) if M else 0.0
    split_cap = 16 if med_nnz <= 24 else 256
    csr_k, seg_map = csr.split_heavy_rows(split_cap, strided=split_cap < 256)
    if seg_map is not None:
        fstats["heavy_row_segments"] = int(csr_k.nrows - M)
        log(f"[{name}] split {csr_k.nrows - M} heavy-row segments "
            f"(rows {M} -> {csr_k.nrows})")

    def to_rows(y, ids=None):
        """Kernel output slots -> the M original rows, in fp64: ``ids`` maps
        each slot to its row of ``csr_k`` (None: the identity); the segment
        map then picks the original row."""
        if ids is not None:
            ids = np.asarray(ids, np.int64)
        if seg_map is not None:
            seg = np.asarray(seg_map)
            ids = seg if ids is None else seg[ids]
        if ids is None:
            return y[:M]
        return np.bincount(ids, weights=y[: ids.size], minlength=M)[:M]

    def record(stage, sec, ref, y, what=""):
        dm = difference_metrics(ref, y)
        scale = float(np.abs(ref).max()) if ref.size else 0.0
        err = float(np.abs(y - ref).max()) / scale if scale else 0.0
        stages[stage] = StageResult(stage, sec,
                                    calculate_flops(nnz, sec) / 1e9, dm, err)
        log(f"[{name}] {stage}: {sec*1e3:.3f} ms = "
            f"{stages[stage].gflops:.3f} GFLOPS{what} on {device}, "
            f"sig_diffs={dm.significant_diffs}, max_rel={dm.max_rel_err:.2e}"
            f", norm_err={err:.2e}")

    def timed(fn, *args):
        return time_fn(fn, *args, device=device, reps=cfg.iterations,
                       skip=cfg.skip)

    xt = device_put_x(x, N, device=device)
    xh, xl = device_put_x_dd(x, N, device=device)
    want = set(cfg.stages)

    if want & set(_SELL_STAGES):
        _sell_stages(res, csr, csr_k, seg_map, x, y_ref, xt, xh, xl, want,
                     record, timed, log, device)

    # --- PR: gather in column order, route to sigma order, reduce ---
    if "pr" in want:
        t0 = time.perf_counter()
        res.pr = pr_from_csr(csr_k, target_rows=PANEL_TARGET_ROWS)
        fstats["convert_pr_s"] = time.perf_counter() - t0
        fstats["pr"] = res.pr.memory_stats()
        d = device_put_pr(res.pr, device=device)
        y = pr_spmv(d, xt).cpu().numpy().astype(np.float64)
        sec = timed(pr_spmv, d, xt)
        record("pr", sec, y_ref, to_rows(y, res.pr.row_perm),
               f" (pad {res.pr.padding_ratio:.2f})")
        del d
    if "pr_dd" in want:
        t0 = time.perf_counter()
        # the routing does not depend on the value type: the f32
        # conversion serves when every problem is within the dd cap
        cap = min(DD_PANEL_TARGET_ROWS, max_pr_rows(N, dd=True))
        pr_dd = res.pr
        if pr_dd is None or any(q.n_rows > cap for q in
                                getattr(pr_dd, "panels", (pr_dd,))):
            pr_dd = pr_from_csr(csr_k, target_rows=DD_PANEL_TARGET_ROWS,
                                dd=True)
        fstats["convert_pr_dd_s"] = time.perf_counter() - t0
        d = device_put_pr_dd(pr_dd, device=device)
        y64 = combine_f64(*pr_spmv_dd(d, xh, xl)).cpu().numpy()
        sec = timed(pr_spmv_dd, d, xh, xl)
        record("pr_dd", sec, y_ref, to_rows(y64, pr_dd.row_perm),
               " (fp64-class)")
        del d

    # --- split: near SELL + natural-order PR far side ---
    sm = None
    if want & {"split", "split_dd"}:
        t0 = time.perf_counter()
        try:
            sm = SplitMatrix.from_csr(csr_k)
        except ValueError as e:
            for stage in ("split", "split_dd"):
                if stage in want:
                    res.skipped[stage] = str(e)
                    log(f"[{name}] {stage} skipped: {e}")
        else:
            fstats["convert_split_s"] = time.perf_counter() - t0
            fstats["split"] = sm.memory_stats()
            res.split = sm
    if sm is not None and "split" in want:
        d = device_put_split(sm, device=device)
        y = split_spmv(d, xt).cpu().numpy().astype(np.float64)
        sec = timed(split_spmv, d, xt)
        record("split", sec, y_ref, to_rows(y),
               f" (slab_dist {sm.slab_dist}, far {sm.far_frac:.3f})")
        del d
    if sm is not None and "split_dd" in want:
        # the same host product: the routing and the near bins do not
        # depend on the value type
        d = device_put_split_dd(sm, device=device)
        y64 = combine_f64(*split_spmv_dd(d, xh, xl)).cpu().numpy()
        sec = timed(split_spmv_dd, d, xh, xl)
        record("split_dd", sec, y_ref, to_rows(y64), " (fp64-class)")
        del d
    if want & {"sell_spmm", "bsr_spmm"}:
        _spmm_stages(res, csr, csr_k, seg_map, want, timed, log, device)
    return res


def _build_sell(csr_k, name, log, **kw) -> SellMatrix:
    """``SellMatrix.from_csr(csr_k, **kw)``; pathological plain conversions
    (power-law heads: bins with k > 1024 or padding above 8x) fall back to
    SELL-sigma row sorting, as the JAX harness's build_sell does."""
    sell = SellMatrix.from_csr(csr_k, **kw)
    if any(b.k > 1024 for b in sell.bins) or sell.padding_ratio > 8:
        log(f"[{name}] plain SELL pathological "
            f"(pad {sell.padding_ratio:.1f}, kmax "
            f"{max((b.k for b in sell.bins), default=0)}) -> auto sigma")
        sell = SellMatrix.from_csr(csr_k, sigma_sort=True, **kw)
    return sell


def _kernel_ids(sell, seg_map, n_rows: int):
    """Kernel output slot -> original row (None: the identity): the sigma
    permutation picks the segment of the ``n_rows``-row split CSR, the
    segment map its row."""
    if seg_map is None and sell.row_perm is None:
        return None
    ids = seg_map if seg_map is not None else np.arange(n_rows)
    if sell.row_perm is not None:
        ids = np.asarray(ids)[sell.row_perm]
    return np.asarray(ids, np.int64)


def _sell_stages(res, csr, csr_k, seg_map, x, y_ref, xt, xh, xl, want,
                 record, timed, log, device):
    """The SELL stages: ``sell``, ``sell_bf16`` and ``sell_dd``."""
    name, M, fstats = res.name, res.nrows, res.format_stats

    t0 = time.perf_counter()
    sell = res.sell = _build_sell(csr_k, name, log)
    fstats["convert_sell_s"] = time.perf_counter() - t0
    fstats["sell"] = sell.memory_stats()

    ids = _kernel_ids(sell, seg_map, csr_k.nrows)
    if ids is not None:
        ids = torch.from_numpy(ids).to(device)

    def run_stage(stage, dtype, ref):
        d = device_put_sell(sell, dtype, device=device)
        y = sell_spmv(d, xt)
        if ids is not None:
            y = torch.zeros(M, dtype=y.dtype, device=device).index_add_(
                0, ids, y)
        # the timed call is the SpMV itself; the segment reduction is an
        # epilogue the JAX harness also keeps out of the timed path
        sec = timed(sell_spmv, d, xt)
        record(stage, sec, ref, y.cpu().numpy().astype(np.float64))

    if "sell" in want:
        run_stage("sell", torch.float32, y_ref)
    if "sell_bf16" in want:
        csr_q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                          quantize_bf16(csr.values))
        run_stage("sell_bf16", torch.bfloat16, csr_q.spmv(x))
    if "sell_dd" not in want:
        return

    # fp64-class: slot-packed sg bins sum several slots onto one row, which
    # the dd kernels refuse, so such a SELL is rebuilt in rows mode (the
    # same sigma rule; run_matrix builds no column panels)
    sell_dd = sell
    if any(b.sg_slots for b in sell.bins):
        t0 = time.perf_counter()
        sell_dd = _build_sell(csr_k, name, log, sg_slots=False)
        fstats["convert_sell_dd_s"] = time.perf_counter() - t0
        log(f"[{name}] slot-packed sg bins -> rows-mode SELL for sell_dd "
            f"in {fstats['convert_sell_dd_s']:.2f} s")
    res.sell_dd = sell_dd
    d = device_put_sell_dd(sell_dd, device=device)
    y64 = combine_f64(*sell_spmv_dd(d, xh, xl)).cpu().numpy()
    ids_dd = _kernel_ids(sell_dd, seg_map, csr_k.nrows)
    if ids_dd is not None:  # host-exact f64 segment reduction
        y64 = np.bincount(ids_dd, weights=y64, minlength=M)[:M]
    sec = timed(sell_spmv_dd, d, xh, xl)
    record("sell_dd", sec, y_ref, y64, " (fp64-class)")


def _spmm_stages(res, csr, csr_k, seg_map, want, timed, log, device):
    """The SpMM stages: ``sell_spmm`` and ``bsr_spmm``."""
    name, M, N, fstats = res.name, res.nrows, res.ncols, res.format_stats
    cfg, stages = res.config, res.stages

    def record(stage, sec, X, Y, rhs, what=""):
        """Validate ``Y`` against the fp64 oracle on sampled columns."""
        dm = sampled_spmm_metrics(csr, X, Y)
        cols = np.unique(np.linspace(0, rhs - 1, min(4, rhs)).astype(int))
        refs = [csr.spmv(X[:, c].astype(np.float64)) for c in cols]
        scale = max((float(np.abs(r).max()) for r in refs if r.size),
                    default=0.0)
        err = max((float(np.abs(Y[:M, c] - r).max())
                   for c, r in zip(cols, refs) if r.size), default=0.0)
        stages[stage] = StageResult(
            stage, sec, calculate_flops(csr.nnz * rhs, sec) / 1e9, dm,
            err / scale if scale else 0.0, rhs)
        log(f"[{name}] {stage}: {sec*1e3:.3f} ms = "
            f"{stages[stage].gflops:.3f} GFLOPS (R={rhs}{what}) on {device}, "
            f"sig_diffs={dm.significant_diffs}, max_rel={dm.max_rel_err:.2e}"
            f", norm_err={stages[stage].norm_err:.2e}")

    if "sell_spmm" in want:
        R = int(cfg.sell_spmm_rhs)
        t0 = time.perf_counter()
        sm = res.sell_spmm = _build_sell(csr_k, name, log, layout="k-major")
        fstats["convert_sell_spmm_s"] = time.perf_counter() - t0
        d = device_put_sell(sm, torch.float32, device=device)
        X = np.random.default_rng(0).standard_normal((N, R), dtype=np.float32)
        xt = device_put_x_multi(X, N, device=device)
        y = sell_spmm(d, xt)
        ids = _kernel_ids(sm, seg_map, csr_k.nrows)
        if ids is not None:
            y = torch.zeros(M, R, device=device).index_add_(
                0, torch.from_numpy(ids).to(device), y)
        # the segment reduction stays out of the timed call, as in sell
        sec = timed(sell_spmm, d, xt)
        record("sell_spmm", sec, X, y.cpu().numpy().astype(np.float64), R)
        del d, xt
    if "bsr_spmm" in want:
        B = int(cfg.spmm_rhs)
        t0 = time.perf_counter()
        try:
            bsr = BSRMatrix.from_csr(csr)
        except ValueError as e:  # the byte budget: too scattered for blocks
            res.skipped["bsr_spmm"] = str(e)
            log(f"[{name}] bsr_spmm skipped: {e}")
            return
        fstats["convert_bsr_s"] = time.perf_counter() - t0
        fstats["bsr"] = {"blocks": bsr.n_real_blocks, "kb": bsr.kb,
                         "fill": bsr.fill, "pad_ratio": bsr.pad_ratio,
                         "bytes": bsr.nbytes}
        res.bsr = bsr
        d = device_put_bsr(bsr, device=device)
        X = np.random.default_rng(0).standard_normal((N, B), dtype=np.float32)
        xp = pad_rhs(X, N, device=device)
        y = bsr_spmm(d, xp)[:, :B]
        sec = timed(bsr_spmm, d, xp)
        record("bsr_spmm", sec, X, y.cpu().numpy().astype(np.float64), B,
               f", fill {bsr.fill:.3f}, kb {bsr.kb}")
