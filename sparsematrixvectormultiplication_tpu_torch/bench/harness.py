"""Benchmark harness — stage runner with validation (≙ main.c / main_cuda.cu).

Per matrix: convert to CSR (optionally RCM-reordered), then run the
configured stages, validate every stage against the serial fp64 CSR oracle
(≙ main.c:145,207,260,310,362) and report its time and GFLOPS = 2·nnz/t.
Stages, in the order they run:

* ``serial_csr`` — the host fp64 oracle itself; always runs;
* ``serial_hll`` — the host HLL SpMV (≙ the reference's spmv_hll_serial);
* ``csr`` / ``ell`` — plain PyTorch CSR (``index_select`` + ``index_add_``)
  and padded-ELL SpMV over the HLL rectangle (≙ the JAX ``xla_csr`` /
  ``xla_ell``); an ELL rectangle past ``ELL_MAX_ELEMENTS`` or an upload
  past ``ops.xla.MAX_UPLOAD_BYTES`` records the stage as skipped;
* ``sell`` — SELL, ``sell_layout`` bins (default "auto"), on ``device``;
* ``sell_bf16`` — bf16 values, x and sums in f32, validated against the
  fp64 SpMV of the bf16-quantized matrix, so the check isolates the kernels
  from the storage rounding;
* ``sell_dd`` — fp64-class double-double (≙ ``pallas_sell_dd``): values
  and x split into f32 (hi, lo) pairs, y combined and segment-summed in
  fp64 and validated against the fp64 oracle, on the same SELL as
  ``sell`` (the dd kernels take slot-packed sg bins);
* ``hll`` — the HLL matrix, padding slots kept, on the SELL kernels
  (≙ ``pallas_hll``); skipped past ``ELL_MAX_ELEMENTS`` padded entries or a
  block MAXNZ above 256, as the JAX harness skips it;
* ``sell_sigma`` — SELL-C-sigma (rows sorted by length, ≙
  ``pallas_sell_sigma``); its rows map back through the permutation;
* ``pr`` / ``pr_dd`` — the PR permutation-routed layout, f32 (or bf16)
  and dd (≙ ``pallas_pr`` / ``pallas_pr_dd``), built from the heavy-row-split
  CSR with ``target_rows=PANEL_TARGET_ROWS``; ``pr_dd`` reuses the f32
  conversion when every problem is within the dd cap. Their y is in sigma
  order and goes back to rows through ``unpermute`` or, after a heavy-row
  split, ``seg_map[pr.row_perm]`` and an fp64 ``np.bincount``;
* ``split`` / ``split_dd`` — the locality split (near SELL + PR far side,
  ≙ ``pallas_split`` / ``pallas_split_dd``). A matrix with no profitable
  near threshold records the stage as skipped, with the reason;
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

``BenchConfig.dtype`` is the value (and x) type of the stages the JAX
harness uploads in it: ``csr``, ``ell``, ``sell``, ``hll``, ``sell_sigma``,
``pr``, ``split``, ``sell_spmm`` and ``bsr_spmm``. "bfloat16" rounds their
values and x to bf16 as the JAX uploads do; the port sums in f32 where the
JAX kernels sum in bf16, so those stages validate against the oracle of the
bf16-rounded values and x, as ``sell_bf16`` does. "float64" runs ``csr`` and
``ell`` in fp64; the port's kernels take f32 or bf16 values (fp64-class is
``sell_dd`` / ``pr_dd`` / ``split_dd``), so its kernel stages are recorded
as skipped.

The JAX config's knobs that the sweep CLI sets are ``BenchConfig``'s too,
with the JAX defaults: ``hack_size`` (HLL block rows), ``sell_merge_bins``, ``sell_chunk_k`` (> 0 forces the sb-major chunk
height), ``abs_tol`` / ``rel_tol`` (``difference_metrics``), ``validate``
(False records empty ``DiffMetrics``) and ``autotune``. ``autotune`` runs
:func:`..tune.autotune.autotune_sell` and ``autotune_hack_size`` on the CSR
before the stages, on ``device`` (measured on a CUDA device, modeled on the
CPU): the picked ladder, layout and merge replace the SELL keywords, the
picked bin assembly runs ``sell`` and ``sell_bf16``, the picked hack size
builds the HLL, and ``format_stats["tune"]`` records the pick and the
tables, with the JAX harness's keys. A tuned SELL that fails raises like
any other stage: nothing falls back to the default ladder. The rest keep
the JAX defaults: ``ELL_MAX_ELEMENTS`` and the flush before every stage.

Timing (``StageResult``): before each device stage's correctness pass,
:func:`flush_hbm` scrubs the cache, as the JAX harness does.
``seconds`` on a CUDA device is the best of ``rounds`` device
times of ``iterations`` calls back to back (``utils.timing.
device_time_fn``; ≙ the JAX ``time_device_fn_slope``, chained calls with no
host in between), fewer where they would queue more than
``utils.timing.MAX_QUEUED_LAUNCHES`` (400) launches behind its spin: a
SELL whose call queues more than 20 (``ops.sell.sell_spmv_launches``: its
launch plan's joint launches and a zero fill where the core bins leave a
group unwritten; "sum": more than 6 bins), ``sell_dd`` likewise
(``sell_spmv_dd_launches``); ``per_call_s`` is the median of ``iterations`` calls each
bracketed by CUDA events, host dispatch included. On the CPU ``seconds`` is
the best of ``rounds`` host medians. The flush removes what one stage left
in the cache for the next; it does not make the timed reps cold (they run
back to back, so x stays in the L2 between them). ``device_validate`` adds
``run_device_validated``'s check of every rep against the first to
``StageResult.extra``, with its time per rep against ``per_call_s`` (both
bracket calls that the host dispatches in between).

Every stage records its norm-scaled error ``max|y - y_ref| / max|y_ref|``
(SpMM: over the sampled columns), and every device stage in
``StageResult.extra["device_bytes"]`` the bytes of the tensors it ran on:
its planes and tables, its x and its y; ``extra["reps"]`` holds the
calls a round of ``seconds`` timed (``iterations``, or fewer on the card
under the launch cap). The SELL-kernel stages record the seconds of their
upload, the device's work on it included, in
``format_stats["upload_<stage>_s"]``. Any other failure of a stage raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.bsr import BSRMatrix
from ..formats.coo import COOMatrix
from ..formats.csr import CSRMatrix
from ..formats.hll import DEFAULT_HACK_SIZE, HLLMatrix
from ..formats.pr import PANEL_TARGET_ROWS, max_pr_rows, pr_from_csr
from ..formats.reorder import reorder_rcm
from ..formats.sell import SellMatrix
from ..formats.split import SplitMatrix
from ..ops.bsr import bsr_spmm, device_put_bsr, pad_rhs
from ..ops.doubledouble import combine_f64
from ..ops.hll import hll_to_sell
from ..ops.pr import device_put_pr, pr_spmv
from ..ops.pr_dd import DD_PANEL_TARGET_ROWS, device_put_pr_dd, pr_spmv_dd
from ..ops.sell import (device_put_sell, device_put_x, sell_spmv,
                        sell_spmv_launches)
from ..ops.sell_dd import (device_put_sell_dd, device_put_x_dd, sell_spmv_dd,
                           sell_spmv_dd_launches)
from ..ops.sell_spmm import device_put_x_multi, sell_spmm
from ..ops.split import (device_put_split, device_put_split_dd, split_spmv,
                         split_spmv_dd)
from ..ops.xla import device_put_csr, device_put_ell
from ..tune.autotune import autotune_hack_size, autotune_sell
from ..utils.metrics import calculate_flops
from ..utils.timing import (ITERATION_SKIP, MAX_QUEUED_LAUNCHES,
                            device_time_fn, run_device_validated, time_fn)
from ..utils.validation import (DEFAULT_ABS_TOL, DEFAULT_REL_TOL,
                                DiffMetrics, difference_metrics,
                                sampled_spmm_metrics)

__all__ = ["BenchConfig", "StageResult", "MatrixResult", "run_matrix",
           "quantize_bf16", "flush_hbm", "device_bytes", "STAGES", "DTYPES",
           "ELL_MAX_ELEMENTS"]

STAGES = ("serial_hll", "csr", "ell", "sell", "sell_bf16", "sell_dd", "hll",
          "sell_sigma", "pr", "pr_dd", "split", "split_dd", "sell_spmm",
          "bsr_spmm")
_SELL_STAGES = ("sell", "sell_bf16", "sell_dd")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
# stages that run a kernel of the port, which takes f32 or bf16 values
_KERNEL_DT_STAGES = ("sell", "hll", "sell_sigma", "pr", "split", "sell_spmm",
                     "bsr_spmm")
_HLL_MAX_MAXNZ = 256  # the JAX harness's pallas_hll skip (harness.py:525)
_FLUSH_MIN_BYTES = 64 << 20  # the JAX flush_hbm's 64 MB
# the ELL rectangle / HLL padded-area cap (the JAX ell_max_elements default)
ELL_MAX_ELEMENTS = 1 << 27


@dataclass
class BenchConfig:
    iterations: int = 20          # calls per timing round
    skip: int = ITERATION_SKIP    # warm-up calls (≙ utility.h:7)
    rounds: int = 3               # timing rounds; the best one is reported
    stages: tuple = _SELL_STAGES  # device stages, in STAGES order
    dtype: str = "float32"        # value/x type of the stages the JAX harness
                                  # uploads in its dtype (see module doc)
    sell_layout: str = "auto"     # "auto" | "k-major" | "sb-major" | "sb-list"
                                  # ... (SellMatrix.from_csr's layouts)
    reorder: str = "none"         # "none" | "rcm" | "auto": P A Pᵀ bandwidth
                                  # reduction before the oracle
    device_validate: bool = False  # check every timed rep against the first
                                   # on the device, one readback
    sell_spmm_rhs: int = 16       # R of the sell_spmm stage (<= MAX_RHS)
    spmm_rhs: int = 128           # B of the bsr_spmm stage
    hack_size: int = DEFAULT_HACK_SIZE  # HLL block rows (hll_matrix.h:12)
    abs_tol: float = DEFAULT_ABS_TOL    # significant-difference tolerances
    rel_tol: float = DEFAULT_REL_TOL    # (≙ main.c:145)
    validate: bool = True
    autotune: bool = False        # pick the SELL ladder/layout, the bin
                                  # assembly and the hack size by measurement
                                  # (≙ cudaOccupancyMaxPotentialBlockSize)
    sell_merge_bins: bool = True  # False keeps span/layout sub-bins apart
    sell_chunk_k: int = 0         # > 0 forces the sb-major chunk height


@dataclass
class StageResult:
    stage: str
    seconds: float          # the stage statistic (module doc)
    gflops: float
    diff: DiffMetrics
    norm_err: float = 0.0   # max|y - y_ref| / max|y_ref|
    rhs: int = 1            # right-hand sides per call (GFLOPS counts all)
    per_call_s: float = 0.0  # median of single calls, host included
    extra: dict = field(default_factory=dict)


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
                                       # (reordered under cfg.reorder)
    sell: SellMatrix | None = None     # the host SELL sell/sell_bf16 ran
    sell_dd: SellMatrix | None = None  # the one sell_dd ran: sell
    hll: HLLMatrix | None = None       # serial_hll / ell / hll's HLL
    sell_sigma: SellMatrix | None = None  # the SELL-C-sigma sell_sigma ran
    pr: object = None       # PRMatrix | PanelPRMatrix the pr stage ran
    split: object = None    # SplitMatrix the split stage ran
    sell_spmm: SellMatrix | None = None  # the k-major SELL sell_spmm ran
    bsr: BSRMatrix | None = None         # the blocks bsr_spmm ran
    skipped: dict = field(default_factory=dict)  # stage -> reason
    device: str = "cpu"     # where the device stages ran ("cuda:0", "cpu")

    def speedup(self, stage: str, baseline: str = "serial_csr") -> float:
        b, s = self.stages.get(baseline), self.stages.get(stage)
        if not b or not s or s.seconds <= 0:
            return 0.0
        return b.seconds / s.seconds


def quantize_bf16(values: np.ndarray) -> np.ndarray:
    """fp64 copy of ``values`` rounded to bf16 exactly as the device upload
    rounds them."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        torch.bfloat16).to(torch.float64).numpy()


def flush_hbm(device, mbytes: int | None = None) -> int:
    """Scrub the device's cache (≙ the JAX ``flush_hbm``, clear_cache,
    utility.c:141-159 / clear_gpu_cache, cuda_src/utility.cu:148-175): read
    and write a buffer of at least twice the L2, never under 64 MB (or
    ``mbytes`` MB when larger), and wait for it. Returns the buffer's bytes;
    on the CPU it does nothing and returns 0."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    nbytes = max(2 * l2, _FLUSH_MIN_BYTES, (mbytes or 0) << 20)
    # the caching allocator hands the same block back on the next call
    buf = torch.ones(-(-nbytes // 4), dtype=torch.float32, device=device)
    buf.mul_(1.0000001)
    torch.cuda.synchronize(device)
    return buf.numel() * 4


def device_bytes(*objs) -> int:
    """Bytes of the distinct tensors in ``objs``: tensors and the
    dataclasses, lists and tuples that hold them (a device container, its
    x tables, its y)."""
    sizes = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            ptr = o.data_ptr()
            sizes[ptr] = max(sizes.get(ptr, 0), o.numel() * o.element_size())
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)

    walk(objs)
    return sum(sizes.values())


def _csr_with(csr: CSRMatrix, values: np.ndarray) -> CSRMatrix:
    return CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, values)


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
    body of main.c:39-459 / main_cuda.cu:52-729). SELL bins take
    ``cfg.sell_layout`` (or the tuner's pick), rebuilt with SELL-sigma row
    order when the plain conversion is pathological; differences count at
    ``cfg.abs_tol`` / ``cfg.rel_tol``."""
    unknown = [s for s in cfg.stages if s not in STAGES]
    if unknown:
        raise ValueError(f"unknown stages {unknown}; the port runs {STAGES}")
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: one of {sorted(DTYPES)}")
    if cfg.reorder not in ("none", "rcm", "auto"):
        raise ValueError(f"reorder {cfg.reorder!r}: none, rcm or auto")
    device = torch.device(device)
    dt = DTYPES[cfg.dtype]
    M, N, nnz = coo.nrows, coo.ncols, coo.nnz
    if x is None:
        x = np.ones(N, dtype=np.float64)  # ≙ init_vector_at_one (utility.c:18)

    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(coo)
    fstats = {"csr": csr.memory_stats(),
              "convert_csr_s": time.perf_counter() - t0}
    if cfg.reorder != "none" and M == N:
        # bandwidth-reducing preprocessing: the SpMV workload is unchanged
        # (same nnz and FLOPs, y' = P y); every stage, the oracle included,
        # runs the permuted problem
        csr, perm, fstats["reorder"] = reorder_rcm(
            csr, mode=cfg.reorder, log=lambda m: log(f"[{name}] {m}"))
        if perm is not None:
            x = np.asarray(x)[perm]
    stages: dict = {}
    res = MatrixResult(name, M, N, nnz, stages, fstats, cfg, csr=csr,
                       device=str(device))

    # --- golden oracle: host fp64 serial CSR (≙ csr_matrix_vector_mult) ---
    times = []
    for _ in range(min(cfg.skip, 2) + 3):
        t0 = time.perf_counter()
        y_ref = csr.spmv(x)
        times.append(time.perf_counter() - t0)
    sec = min(times)
    stages["serial_csr"] = StageResult(
        "serial_csr", sec, calculate_flops(nnz, sec) / 1e9, DiffMetrics(),
        per_call_s=sec)
    log(f"[{name}] serial_csr: {sec*1e3:.3f} ms = "
        f"{stages['serial_csr'].gflops:.3f} GFLOPS (host fp64 oracle)")

    # the x and oracle of the stages that take cfg.dtype: bf16 rounds values
    # and x as the uploads do
    x_dt, y_dt = x, y_ref
    if dt == torch.bfloat16:
        x_dt = quantize_bf16(x)
        y_dt = _csr_with(csr, quantize_bf16(csr.values)).spmv(x_dt)

    sell_kw = {"layout": cfg.sell_layout, "merge_bins": cfg.sell_merge_bins}
    if cfg.sell_chunk_k > 0:
        sell_kw.update(chunk_k=cfg.sell_chunk_k, chunk_k_forced=True)
    assembly, hack_size = "auto", cfg.hack_size
    if cfg.autotune:
        sell_kw, assembly, hack_size = _autotune(res, sell_kw, x, dt, device,
                                                 log)

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

    want = set(cfg.stages)
    if dt == torch.float64:
        for stage in sorted(want & set(_KERNEL_DT_STAGES)):
            _skip(res, log, stage, "dtype float64: the port's kernels take "
                  "float32 or bfloat16 values (fp64-class: sell_dd, pr_dd, "
                  "split_dd)")
        want -= set(_KERNEL_DT_STAGES)
    xt = device_put_x(x_dt, N, device=device)
    xh, xl = device_put_x_dd(x, N, device=device)

    if want & {"serial_hll", "csr", "ell", "hll"}:
        _hll_csr_stages(res, want, hack_size, x, x_dt, y_ref, y_dt, dt,
                        device, log)
    if want & set(_SELL_STAGES):
        _sell_stages(res, want, csr_k, seg_map, sell_kw, assembly, x_dt,
                     y_ref, y_dt, xt, xh, xl, dt, device, log)
    if "hll" in want:
        _hll_stage(res, xt, y_dt, dt, device, log)

    # --- SELL-C-sigma: rows sorted by length ---
    if "sell_sigma" in want:
        t0 = time.perf_counter()
        sig = res.sell_sigma = _build_sell(csr_k, name, log, sigma_sort=True)
        fstats["convert_sell_sigma_s"] = time.perf_counter() - t0
        fstats["sell_sigma"] = sig.memory_stats()
        _run_sell(res, "sell_sigma", sig, _kernel_ids(sig, seg_map,
                                                      csr_k.nrows),
                  dt, xt, y_dt, device, log, f" (pad {sig.padding_ratio:.2f})",
                  padding_ratio=sig.padding_ratio)

    # --- PR: gather in column order, route to sigma order, reduce ---
    if "pr" in want:
        t0 = time.perf_counter()
        res.pr = pr_from_csr(csr_k, target_rows=PANEL_TARGET_ROWS)
        fstats["convert_pr_s"] = time.perf_counter() - t0
        fstats["pr"] = res.pr.memory_stats()
        d = device_put_pr(res.pr, dt, device=device)
        flush_hbm(device)
        y = pr_spmv(d, xt).cpu().numpy().astype(np.float64)
        _record(res, device, log, "pr", _timed(cfg, device, pr_spmv, d, xt),
                y_dt, to_rows(y, res.pr.row_perm),
                f" (pad {res.pr.padding_ratio:.2f}, {str(dt)[6:]} values)",
                padding_ratio=res.pr.padding_ratio)
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
        flush_hbm(device)
        y64 = combine_f64(*pr_spmv_dd(d, xh, xl)).cpu().numpy()
        _record(res, device, log, "pr_dd",
                _timed(cfg, device, pr_spmv_dd, d, xh, xl), y_ref,
                to_rows(y64, pr_dd.row_perm), " (fp64-class)",
                padding_ratio=pr_dd.padding_ratio)
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
                    _skip(res, log, stage, str(e))
        else:
            fstats["convert_split_s"] = time.perf_counter() - t0
            fstats["split"] = sm.memory_stats()
            res.split = sm
    if sm is not None and "split" in want:
        d = device_put_split(sm, dt, device=device)
        flush_hbm(device)
        y = split_spmv(d, xt).cpu().numpy().astype(np.float64)
        _record(res, device, log, "split",
                _timed(cfg, device, split_spmv, d, xt), y_dt, to_rows(y),
                f" (slab_dist {sm.slab_dist}, far {sm.far_frac:.3f})")
        del d
    if sm is not None and "split_dd" in want:
        # the same host product: the routing and the near bins do not
        # depend on the value type
        d = device_put_split_dd(sm, device=device)
        flush_hbm(device)
        y64 = combine_f64(*split_spmv_dd(d, xh, xl)).cpu().numpy()
        _record(res, device, log, "split_dd",
                _timed(cfg, device, split_spmv_dd, d, xh, xl), y_ref,
                to_rows(y64), " (fp64-class)")
        del d
    if want & {"sell_spmm", "bsr_spmm"}:
        _spmm_stages(res, want, csr_k, seg_map, dt, device, log)
    return res


def _autotune(res: MatrixResult, sell_kw: dict, x, dt, device, log):
    """Measure the SELL candidates and hack sizes on ``res.csr`` (≙ the JAX
    harness's autotune block); returns the SELL keywords, bin assembly and
    hack size to run, and records ``format_stats["tune"]``. The tuner runs
    the f32 kernels where the stages' dtype is float64 (no SELL stage runs
    then). Nothing here is caught: a launch error raises."""
    name, cfg = res.name, res.config
    tr = autotune_sell(res.csr, x=x, device=device, log=log,
                       dtype=torch.float32 if dt == torch.float64 else dt)
    if tr.best is not None:
        sell_kw = {"layout": tr.best.layout, "k_bins": tr.best.k_bins,
                   "merge_bins": tr.best.merge_bins}
    best_hack, hack_rows = autotune_hack_size(res.csr, log=log)
    # tr.best None: the tuner ran and every candidate was refused, so the
    # configured SELL runs; "default" records that decision
    res.format_stats["tune"] = {
        "ladder": tr.best.name if tr.best else "default",
        "layout": tr.best.layout if tr.best else cfg.sell_layout,
        "assembly": tr.assembly,
        "hack_size": best_hack,
        "table": [(n, s) for n, s, _ in tr.table],
        "hack_table": hack_rows,
    }
    tune = res.format_stats["tune"]
    log(f"[{name}] autotune: ladder={tune['ladder']} layout={tune['layout']} "
        f"assembly={tr.assembly} hack={best_hack}")
    return sell_kw, tr.assembly, best_hack or cfg.hack_size


def _timed(cfg: BenchConfig, device, fn, *args, launches: int = 1):
    """``(seconds, per_call_s, extra)`` of ``fn(*args)``: the stage
    statistic of the module doc; ``extra["device_bytes"]`` counts the
    tensors of ``args`` and of the result. ``launches`` (what one call
    queues) caps the device-time reps at ``MAX_QUEUED_LAUNCHES``."""
    extra = {"device_bytes": device_bytes(args, fn(*args)),
             "reps": cfg.iterations}
    per_call = time_fn(fn, *args, device=device, reps=cfg.iterations,
                       skip=cfg.skip)
    if device.type == "cuda":
        reps = extra["reps"] = max(1, min(
            cfg.iterations, MAX_QUEUED_LAUNCHES // max(launches, 1)))
        sec = min(device_time_fn(fn, *args, device=device, reps=reps,
                                 skip=max(cfg.skip, 1))
                  for _ in range(cfg.rounds))
    else:
        sec = min([per_call] + [
            time_fn(fn, *args, device=device, reps=cfg.iterations,
                    skip=cfg.skip) for _ in range(cfg.rounds - 1)])
    if cfg.device_validate:
        reps = min(cfg.iterations, 16)
        first = fn(*args)
        first = first[0] if isinstance(first, tuple) else first
        diff, dv_sec = run_device_validated(fn, *args, y_ref=first,
                                            device=device, reps=reps)
        extra.update({"device_val_max_diff": diff, "device_val_reps": reps,
                      "device_val_overhead_pct":
                          (dv_sec / per_call - 1.0) * 100.0 if per_call
                          else 0.0})
    return sec, per_call, extra


def _record(res: MatrixResult, device, log, stage, timing, ref, y, what="",
            **extra):
    """Validate ``y`` against ``ref`` (unless ``cfg.validate`` is off) and
    store the stage's result, ``extra`` added to its timing's."""
    sec, per_call, timing_extra = timing
    cfg = res.config
    dm, err = DiffMetrics(), 0.0
    if cfg.validate:
        dm = difference_metrics(ref, y, cfg.abs_tol, cfg.rel_tol)
        scale = float(np.abs(ref).max()) if ref.size else 0.0
        err = float(np.abs(y - ref).max()) / scale if scale else 0.0
    st = res.stages[stage] = StageResult(
        stage, sec, calculate_flops(res.nnz, sec) / 1e9, dm, err,
        per_call_s=per_call, extra={**timing_extra, **extra})
    log(f"[{res.name}] {stage}: {sec*1e3:.4f} ms = {st.gflops:.3f} GFLOPS"
        f"{what} on {device} (per call {per_call*1e3:.4f} ms), "
        f"sig_diffs={dm.significant_diffs}, max_rel={dm.max_rel_err:.2e}, "
        f"norm_err={err:.2e}")


def _skip(res: MatrixResult, log, stage, reason):
    res.skipped[stage] = reason
    log(f"[{res.name}] {stage} skipped: {reason}")


def _build_sell(csr_k, name, log, **kw) -> SellMatrix:
    """``SellMatrix.from_csr(csr_k, **kw)``; pathological plain conversions
    (power-law heads: bins with k > 1024 or padding above 8x) fall back to
    SELL-sigma row sorting, as the JAX harness's build_sell does."""
    sell = SellMatrix.from_csr(csr_k, **kw)
    if not kw.get("sigma_sort") and (
            any(b.k > 1024 for b in sell.bins) or sell.padding_ratio > 8):
        log(f"[{name}] plain SELL pathological "
            f"(pad {sell.padding_ratio:.1f}, kmax "
            f"{max((b.k for b in sell.bins), default=0)}) -> auto sigma")
        sell = SellMatrix.from_csr(csr_k, **{**kw, "sigma_sort": True})
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


def _upload(res, stage, device, put, *args):
    """``put(*args, device=device)``, its seconds until the device is done
    recorded as ``format_stats["upload_<stage>_s"]``."""
    t0 = time.perf_counter()
    d = put(*args, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    res.format_stats[f"upload_{stage}_s"] = time.perf_counter() - t0
    return d


def _run_sell(res, stage, sell, ids, dtype, xt, ref, device, log, what="",
             assembly="auto", **extra):
    """Upload ``sell`` with ``dtype`` values, flush, run it once with the
    bin ``assembly`` of :func:`..ops.sell.sell_spmv`, map its rows back
    through ``ids`` (:func:`_kernel_ids`) and time the SpMV; the segment
    reduction is an epilogue kept out of the timed call, as the JAX harness
    keeps it."""
    d = _upload(res, stage, device, device_put_sell, sell, dtype)
    spmv = functools.partial(sell_spmv, assembly=assembly)
    flush_hbm(device)
    y = spmv(d, xt)
    if ids is not None:
        y = torch.zeros(res.nrows, dtype=y.dtype, device=device) \
            .index_add_(0, torch.from_numpy(ids).to(device), y)
    timing = _timed(res.config, device, spmv, d, xt,
                    launches=sell_spmv_launches(d, assembly))
    _record(res, device, log, stage, timing, ref,
            y.cpu().numpy().astype(np.float64), what, **extra)


def _hll_csr_stages(res, want, hack_size, x, x_dt, y_ref, y_dt, dt, device,
                    log):
    """``serial_hll`` (host), ``csr`` and ``ell`` (plain PyTorch)."""
    csr, fstats, cfg = res.csr, res.format_stats, res.config
    if want & {"serial_hll", "ell", "hll"}:
        t0 = time.perf_counter()
        res.hll = HLLMatrix.from_csr(csr, hack_size)
        fstats["convert_hll_s"] = time.perf_counter() - t0
        fstats["hll"] = res.hll.memory_stats()
    if "serial_hll" in want:
        t0 = time.perf_counter()
        y = res.hll.spmv(x)
        sec = time.perf_counter() - t0
        _record(res, device, log, "serial_hll", (sec, sec, {}), y_ref, y,
                " (host fp64)")
    xd = torch.from_numpy(np.asarray(x_dt, np.float64)).to(dt).to(device)
    spmv = lambda dd, xx: dd.spmv(xx)
    if "csr" in want:
        try:
            d = device_put_csr(csr, dt, device=device)
        except MemoryError as e:
            _skip(res, log, "csr", str(e))
        else:
            flush_hbm(device)
            y = spmv(d, xd).cpu().numpy().astype(np.float64)
            _record(res, device, log, "csr", _timed(cfg, device, spmv, d, xd),
                    y_dt, y, f" ({str(dt)[6:]} values)")
            del d
    if "ell" in want:
        try:
            d = device_put_ell(res.hll, dt, device=device,
                               max_elements=ELL_MAX_ELEMENTS)
        except MemoryError as e:
            _skip(res, log, "ell", str(e))
        else:
            flush_hbm(device)
            y = spmv(d, xd).cpu().numpy().astype(np.float64)
            _record(res, device, log, "ell", _timed(cfg, device, spmv, d, xd),
                    y_dt, y, f" (rect {tuple(d.ja.shape)})")
            del d


def _hll_stage(res, xt, y_dt, dt, device, log):
    """``hll``: the HLL matrix's padded rows on the SELL kernels."""
    hll = res.hll
    padded = int(hll.memory_stats()["padded_nnz"])
    maxnz = int(np.asarray(hll.maxnz).max()) if hll.num_blocks else 0
    if padded > ELL_MAX_ELEMENTS or maxnz > _HLL_MAX_MAXNZ:
        # monster blocks (power-law heads): the reference's own HLL
        # collapse regime
        _skip(res, log, "hll", f"HLL padded area {padded} (cap "
              f"{ELL_MAX_ELEMENTS}) / max block MAXNZ {maxnz} (cap "
              f"{_HLL_MAX_MAXNZ})")
        return
    t0 = time.perf_counter()
    sell = hll_to_sell(hll)
    res.format_stats["convert_hll_sell_s"] = time.perf_counter() - t0
    _run_sell(res, "hll", sell, None, dt, xt, y_dt, device, log,
              f" (padded {padded}, bins "
              f"{sorted({b.layout for b in sell.bins})})")


def _sell_stages(res, want, csr_k, seg_map, sell_kw, assembly, x_dt, y_ref,
                 y_dt, xt, xh, xl, dt, device, log):
    """The SELL stages: ``sell``, ``sell_bf16`` and ``sell_dd``, on the SELL
    ``sell_kw`` builds; ``sell`` and ``sell_bf16`` assemble its bins by
    ``assembly``."""
    name, fstats, cfg = res.name, res.format_stats, res.config
    t0 = time.perf_counter()
    sell = res.sell = _build_sell(csr_k, name, log, **sell_kw)
    fstats["convert_sell_s"] = time.perf_counter() - t0
    fstats["sell"] = sell.memory_stats()
    ids = _kernel_ids(sell, seg_map, csr_k.nrows)

    if "sell" in want:
        _run_sell(res, "sell", sell, ids, dt, xt, y_dt, device, log,
                  assembly=assembly)
    if "sell_bf16" in want:
        ref = _csr_with(res.csr, quantize_bf16(res.csr.values)).spmv(x_dt)
        _run_sell(res, "sell_bf16", sell, ids, torch.bfloat16, xt, ref,
                  device, log, assembly=assembly)
    if "sell_dd" not in want:
        return

    res.sell_dd = sell
    d = _upload(res, "sell_dd", device, device_put_sell_dd, sell)
    flush_hbm(device)
    y64 = combine_f64(*sell_spmv_dd(d, xh, xl)).cpu().numpy()
    if ids is not None:  # host-exact f64 segment reduction
        y64 = np.bincount(ids, weights=y64, minlength=res.nrows)[:res.nrows]
    _record(res, device, log, "sell_dd",
            _timed(cfg, device, sell_spmv_dd, d, xh, xl,
                   launches=sell_spmv_dd_launches(d)), y_ref, y64,
            " (fp64-class)")


def _spmm_stages(res, want, csr_k, seg_map, dt, device, log):
    """The SpMM stages: ``sell_spmm`` and ``bsr_spmm``."""
    cfg, csr, stages = res.config, res.csr, res.stages
    name, M, N, fstats = res.name, res.nrows, res.ncols, res.format_stats
    bf16 = dt == torch.bfloat16
    # the oracle's matrix: bf16 values rounded as the upload rounds them
    ocsr = _csr_with(csr, quantize_bf16(csr.values)) if bf16 else csr

    def record(stage, timing, X, Y, rhs, what=""):
        """Validate ``Y`` against the fp64 oracle on sampled columns."""
        sec, per_call, extra = timing
        dm, err, scale = DiffMetrics(), 0.0, 0.0
        if cfg.validate:
            dm = sampled_spmm_metrics(ocsr, X, Y, cfg.abs_tol, cfg.rel_tol)
            cols = np.unique(np.linspace(0, rhs - 1, min(4, rhs)).astype(int))
            refs = [ocsr.spmv(X[:, j].astype(np.float64)) for j in cols]
            scale = max((float(np.abs(r).max()) for r in refs if r.size),
                        default=0.0)
            err = max((float(np.abs(Y[:M, j] - r).max())
                       for j, r in zip(cols, refs) if r.size), default=0.0)
        stages[stage] = StageResult(
            stage, sec, calculate_flops(csr.nnz * rhs, sec) / 1e9, dm,
            err / scale if scale else 0.0, rhs, per_call, extra)
        log(f"[{name}] {stage}: {sec*1e3:.4f} ms = "
            f"{stages[stage].gflops:.3f} GFLOPS (R={rhs}{what}) on "
            f"{device} (per call {per_call*1e3:.4f} ms), sig_diffs="
            f"{dm.significant_diffs}, max_rel={dm.max_rel_err:.2e}"
            f", norm_err={stages[stage].norm_err:.2e}")

    if "sell_spmm" in want:
        R = int(cfg.sell_spmm_rhs)
        t0 = time.perf_counter()
        sm = res.sell_spmm = _build_sell(csr_k, name, log, layout="k-major")
        fstats["convert_sell_spmm_s"] = time.perf_counter() - t0
        d = device_put_sell(sm, dt, device=device)
        X = np.random.default_rng(0).standard_normal((N, R), dtype=np.float32)
        xt = device_put_x_multi(X, N, device=device)
        flush_hbm(device)
        y = sell_spmm(d, xt)
        ids = _kernel_ids(sm, seg_map, csr_k.nrows)
        if ids is not None:
            y = torch.zeros(M, R, device=device).index_add_(
                0, torch.from_numpy(ids).to(device), y)
        # the segment reduction stays out of the timed call, as in sell
        record("sell_spmm", _timed(cfg, device, sell_spmm, d, xt), X,
               y.cpu().numpy().astype(np.float64), R)
        del d, xt
    if "bsr_spmm" in want:
        B = int(cfg.spmm_rhs)
        t0 = time.perf_counter()
        try:
            bsr = BSRMatrix.from_csr(csr)
        except ValueError as e:  # the byte budget: too scattered for blocks
            _skip(res, log, "bsr_spmm", str(e))
            return
        fstats["convert_bsr_s"] = time.perf_counter() - t0
        fstats["bsr"] = {"blocks": bsr.n_real_blocks, "kb": bsr.kb,
                         "fill": bsr.fill, "pad_ratio": bsr.pad_ratio,
                         "bytes": bsr.nbytes}
        res.bsr = bsr
        d = device_put_bsr(bsr, dt, device=device)
        X = np.random.default_rng(0).standard_normal((N, B), dtype=np.float32)
        xp = pad_rhs(X, N, dt, device=device)
        flush_hbm(device)
        y = bsr_spmm(d, xp)[:, :B]
        record("bsr_spmm", _timed(cfg, device, bsr_spmm, d, xp),
               quantize_bf16(X) if bf16 else X,
               y.cpu().numpy().astype(np.float64), B,
               f", fill {bsr.fill:.3f}, kb {bsr.kb}")
