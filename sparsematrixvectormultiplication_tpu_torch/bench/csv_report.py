"""CSV reporting — native schema plus reference-compatible emitters.

The reference writes three CSVs (SURVEY §5 observability):
  * ``spmv_results_openmp.csv`` — 33 columns (src/utility.c:114-120)
  * ``spmv_results_cuda.csv`` — 32 columns (cuda_src/utility.cu:115-123)
  * ``spmv_results_cuda_block_dim.csv`` — chosen launch dims
    (cuda_src/utility.cu:251)

This module writes (a) the native schema with full stage detail and (b) the
reference schemas with a documented mapping of the port's stages onto the
reference's column roles, so tooling written for the reference's CSVs keeps
working. Every header equals the JAX package's byte for byte
(``tests/test_torch_sweep.py`` holds them equal). All writers append,
emitting the header only when the file is new or empty (≙
utility.c:102-121), which keeps interrupted sweeps resumable.

Bytes: ``bytes_streamed_per_nnz`` is the bytes of the tensors a device stage
ran on (its planes and tables, its x and its y, ``StageResult.extra
["device_bytes"]``) over the matrix's nonzeros; a host stage moves none.
``pct_stream_bw`` holds them over the stage's time against the card's
measured copy rate, and reads ``nan`` (not measured) for a run that was not
on a CUDA device.
"""

# Copied from sparsematrixvectormultiplication_tpu/bench/csv_report.py (the
# port must not import the JAX package), with the port's stage names.

from __future__ import annotations

import csv
import os

from .harness import MatrixResult

__all__ = [
    "write_native_row",
    "write_openmp_style_row",
    "write_cuda_style_row",
    "write_memory_stats_row",
    "write_tile_config_row",
    "NATIVE_HEADER",
    "OPENMP_HEADER",
    "CUDA_HEADER",
    "MEMORY_STATS_HEADER",
    "TILE_HEADER",
    "STREAM_BW_BYTES",
]


def _append_row(path: str, header: list, row: list):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    if not new:
        # Fail loudly on schema drift: appending rows of a newer schema
        # under an older header silently misaligns every column after the
        # divergence point (ADVICE r4).
        with open(path, newline="") as f:
            existing = next(csv.reader(f), None)
        if existing is not None and existing != [str(h) for h in header]:
            raise ValueError(
                f"CSV schema mismatch appending to {path}: file header has "
                f"{len(existing)} cols {existing[:4]}..., writer expects "
                f"{len(header)} cols {header[:4]}... — migrate or use a new "
                "result dir")
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(header)
        w.writerow(row)


def _fmt(v: float) -> str:
    return f"{v:.15f}"


NATIVE_HEADER = [
    "matrix_name", "rows", "cols", "nonzeros", "stage", "dtype",
    "arith_class",
    "time_s", "gflops", "speedup_vs_serial",
    "mean_rel_err", "significant_diffs", "max_abs_err", "max_rel_err",
    "padding_ratio", "bytes_streamed_per_nnz", "pct_stream_bw",
]

# The card's measured copy rate (read + write), the %STREAM denominator:
# bench/bw_probe.py's bw_copy on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit (PERF.md §2), 82.7% of the 3.35 TB/s spec.
STREAM_BW_BYTES = 2.7693e12


def _stage_dtype_and_class(stage: str, cfg_dtype: str):
    """dtype/arith labels per stage: the dd stages store f32 (hi, lo) pairs
    but deliver fp64-class results, so they read ``float64-dd``."""
    if stage.startswith("serial"):
        return "float64", "fp64"
    if stage.endswith("_dd") or "_dd_" in stage:
        return "float64-dd", "fp64-class"
    if "bf16" in stage:
        return "bfloat16", "bf16"
    return cfg_dtype, {"float32": "fp32", "float64": "fp64",
                       "bfloat16": "bf16"}.get(cfg_dtype, cfg_dtype)


def _on_card(result: MatrixResult) -> bool:
    return result.device.startswith("cuda")


def _stream_columns(device_bytes: int, nnz: int, seconds: float,
                    on_card: bool) -> tuple:
    """``(bytes_streamed_per_nnz, pct_stream_bw)`` cells of a native row."""
    per_nnz = device_bytes / max(nnz, 1)
    pct = (f"{device_bytes / max(seconds, 1e-12) / STREAM_BW_BYTES * 100:.2f}"
           if on_card else "nan")
    return f"{per_nnz:.2f}", pct


def write_native_row(path: str, result: MatrixResult):
    """One row per (matrix, stage) — the primary schema."""
    default_pad = result.format_stats.get("sell", {}).get("padding_ratio", 1.0)
    for stage, s in result.stages.items():
        pad = s.extra.get("padding_ratio", default_pad)
        dtype, arith = _stage_dtype_and_class(stage, result.config.dtype)
        per_nnz, pct = _stream_columns(s.extra.get("device_bytes", 0),
                                       result.nnz, s.seconds,
                                       _on_card(result))
        _append_row(
            path,
            NATIVE_HEADER,
            [
                result.name, result.nrows, result.ncols, result.nnz, stage,
                dtype, arith,
                _fmt(s.seconds), f"{s.gflops:.6f}",
                f"{result.speedup(stage):.6f}",
                f"{s.diff.mean_rel_err:.15e}", s.diff.significant_diffs,
                f"{s.diff.max_abs_err:.15e}", f"{s.diff.max_rel_err:.15e}",
                f"{pad:.6f}", per_nnz, pct,
            ],
        )


# Exact header of the reference OpenMP CSV (src/utility.c:114-120).
OPENMP_HEADER = (
    "matrix_name,rows,cols,nonzeros,num_threads,"
    "time_serial,time_serial_hll,time_parallel,time_parallel_simd,"
    "time_parallel_hll,time_parallel_hll_simd,"
    "error_csr_relative,error_csr_absolute,error_hll_relative,error_hll_absolute,"
    "error_csr_simd_relative,error_csr_simd_absolute,error_hll_simd_relative,"
    "error_hll_simd_absolute,"
    "flops_serial,flops_serial_hll,flops_parallel,flops_parallel_simd,"
    "flops_parallel_hll,flops_parallel_hll_simd,"
    "speedup_parallel,speedup_simd,speedup_hll,speedup_hll_simd,"
    "efficiency_parallel,efficiency_simd,efficiency_hll,efficiency_hll_simd"
).split(",")

# Stage mapping onto the reference's column roles, each column a DISTINCT
# stage (a duplicate would let tooling compare a kernel against itself);
# the JAX package's pallas_sell / xla_csr / xla_ell / pallas_hll roles:
#   time_parallel          <- sell (the parallel CSR-class kernel)
#   time_parallel_simd     <- csr  (the plain PyTorch CSR SpMV)
#   time_parallel_hll      <- ell  (the padded-HLL rectangle)
#   time_parallel_hll_simd <- hll  (the HLL work profile on the SELL kernels)
_OPENMP_MAP = {
    "parallel": "sell",
    "parallel_simd": "csr",
    "parallel_hll": "ell",
    "parallel_hll_simd": "hll",
}


def write_openmp_style_row(path: str, result: MatrixResult, num_threads: int = 1):
    """Reference-schema row; ``num_threads`` records device count."""
    def sec(stage):
        s = result.stages.get(stage)
        return s.seconds if s else 0.0

    def gf(stage):
        s = result.stages.get(stage)
        return s.gflops * 1e9 if s else 0.0  # reference stores raw FLOPS

    def err(stage):
        s = result.stages.get(stage)
        return (s.diff.mean_rel_err, s.diff.mean_abs_err) if s else (0.0, 0.0)

    sp = {k: result.speedup(v) for k, v in _OPENMP_MAP.items()}
    eff = {k: v / max(num_threads, 1) for k, v in sp.items()}
    e_csr = err(_OPENMP_MAP["parallel"])
    e_hll = err(_OPENMP_MAP["parallel_hll"])
    e_csr_simd = err(_OPENMP_MAP["parallel_simd"])
    e_hll_simd = err(_OPENMP_MAP["parallel_hll_simd"])

    row = [
        result.name, result.nrows, result.ncols, result.nnz, num_threads,
        _fmt(sec("serial_csr")), _fmt(sec("serial_hll")),
        _fmt(sec(_OPENMP_MAP["parallel"])), _fmt(sec(_OPENMP_MAP["parallel_simd"])),
        _fmt(sec(_OPENMP_MAP["parallel_hll"])), _fmt(sec(_OPENMP_MAP["parallel_hll_simd"])),
        _fmt(e_csr[0]), _fmt(e_csr[1]), _fmt(e_hll[0]), _fmt(e_hll[1]),
        _fmt(e_csr_simd[0]), _fmt(e_csr_simd[1]), _fmt(e_hll_simd[0]), _fmt(e_hll_simd[1]),
        _fmt(gf("serial_csr")), _fmt(gf("serial_hll")),
        _fmt(gf(_OPENMP_MAP["parallel"])), _fmt(gf(_OPENMP_MAP["parallel_simd"])),
        _fmt(gf(_OPENMP_MAP["parallel_hll"])), _fmt(gf(_OPENMP_MAP["parallel_hll_simd"])),
        _fmt(sp["parallel"]), _fmt(sp["parallel_simd"]),
        _fmt(sp["parallel_hll"]), _fmt(sp["parallel_hll_simd"]),
        _fmt(eff["parallel"]), _fmt(eff["parallel_simd"]),
        _fmt(eff["parallel_hll"]), _fmt(eff["parallel_hll_simd"]),
    ]
    _append_row(path, OPENMP_HEADER, row)


# Exact header of the reference CUDA CSV (cuda_src/utility.cu:115-123).
CUDA_HEADER = (
    "matrix_name,rows,cols,nonzeros,"
    "time_serial,time_serial_hll,time_row_csr,time_warp_csr,time_warp_shared_csr,"
    "time_row_hll,time_warp_hll,time_warp_shared_hll,"
    "flops_serial,avg_flops_hll_serial,flops_row_csr,flops_warp_csr,"
    "flops_warp_csr_shared,flops_row_hll,flops_warp_hll,flops_warp_shared_hll,"
    "relative_error_row_csr,absolute_error_row_csr,"
    "relative_error_warp_csr,absolute_error_warp_csr,"
    "relative_error_warp_shared_csr,absolute_error_warp_shared_csr,"
    "relative_error_row_hll,absolute_error_row_hll,"
    "relative_error_warp_hll,absolute_error_warp_hll,"
    "relative_error_warp_shared_hll,absolute_error_warp_shared_hll"
).split(",")

# Stage mapping onto the reference's CUDA kernel roles (all fp64 there):
# six DISTINCT stages for six distinct reference kernels, as the JAX
# package maps its own:
#   row_csr         <- pr | csr   (the PR permutation-routed kernel when
#                                  measured, else the plain CSR SpMV)
#   warp_csr        <- sell       (f32)
#   warp_shared_csr <- sell_sigma (row-sorted SELL-C-sigma)
#   row_hll         <- ell        (padded-HLL rectangle)
#   warp_hll        <- sell_dd | pr_dd (fp64-class double-double)
#   warp_shared_hll <- hll        (the HLL work profile on the SELL kernels)
_CUDA_MAP = {
    "row_csr": ("pr", "csr"),
    "warp_csr": ("sell",),
    "warp_shared_csr": ("sell_sigma",),
    "row_hll": ("ell",),
    "warp_hll": ("sell_dd", "pr_dd"),
    "warp_shared_hll": ("hll",),
}


def write_cuda_style_row(path: str, result: MatrixResult):
    def _stage(role):
        for cand in _CUDA_MAP.get(role, (role,)):
            s = result.stages.get(cand)
            if s:
                return s
        return None

    def sec(role):
        s = _stage(role)
        return s.seconds if s else 0.0

    def gf(role):
        s = _stage(role)
        return s.gflops * 1e9 if s else 0.0

    def err(role):
        s = _stage(role)
        return (s.diff.mean_rel_err, s.diff.mean_abs_err) if s else (0.0, 0.0)

    def sser(stage):
        s = result.stages.get(stage)
        return s.seconds if s else 0.0

    def gser(stage):
        s = result.stages.get(stage)
        return s.gflops * 1e9 if s else 0.0

    roles = ["row_csr", "warp_csr", "warp_shared_csr", "row_hll", "warp_hll",
             "warp_shared_hll"]
    errs = [x for r in roles for x in err(r)]
    row = [
        result.name, result.nrows, result.ncols, result.nnz,
        _fmt(sser("serial_csr")), _fmt(sser("serial_hll")),
        _fmt(sec("row_csr")), _fmt(sec("warp_csr")), _fmt(sec("warp_shared_csr")),
        _fmt(sec("row_hll")), _fmt(sec("warp_hll")), _fmt(sec("warp_shared_hll")),
        _fmt(gser("serial_csr")), _fmt(gser("serial_hll")),
        _fmt(gf("row_csr")), _fmt(gf("warp_csr")), _fmt(gf("warp_shared_csr")),
        _fmt(gf("row_hll")), _fmt(gf("warp_hll")), _fmt(gf("warp_shared_hll")),
    ] + [_fmt(e) for e in errs]
    _append_row(path, CUDA_HEADER, row)


MEMORY_STATS_HEADER = [
    "matrix_name", "rows", "cols", "nonzeros", "format",
    "bytes_total", "bytes_per_nnz", "padded_nnz", "padding_ratio",
]


def write_memory_stats_row(path: str, matrix_name: str, fmt: str, stats: dict):
    """Per-format memory footprint row (≙ write_memory_stats_to_csv,
    src/csr_matrix.c:28-61, which the reference defines but never calls)."""
    _append_row(
        path,
        MEMORY_STATS_HEADER,
        [
            matrix_name, stats.get("rows"), stats.get("cols"), stats.get("nnz"),
            fmt, stats.get("bytes_total"),
            f"{stats.get('bytes_total', 0) / max(stats.get('nnz', 1), 1):.3f}",
            stats.get("padded_nnz", stats.get("nnz")),
            f"{stats.get('padding_ratio', 1.0):.6f}",
        ],
    )


TILE_HEADER = [
    "matrix_name", "nonzeros", "kernel", "bin_k", "layout", "n_groups",
    "span", "s_max", "chunk_k", "bin_padding_ratio", "padding_ratio",
    "tuned_ladder", "tuned_hack_size",
]


def write_tile_config_row(path: str, result: MatrixResult):
    """Chosen bin shapes per stage (≙ write_block_result_to_csv,
    cuda_src/utility.cu:236-261: the reference logs its chosen CUDA block
    dims; this logs every SELL bin's geometry plus the autotuner's picks)."""
    tune = result.format_stats.get("tune", {})
    ladder = tune.get("ladder", "")
    hack = tune.get("hack_size", "")
    for fmt in ("sell", "sell_sigma"):
        sell = result.format_stats.get(fmt)
        if not sell:
            continue
        for b in sell.get("bins", []):
            _append_row(
                path,
                TILE_HEADER,
                [result.name, result.nnz, fmt, b["k"], b["layout"],
                 b["n_groups"], b["span"], b["s_max"], b["chunk_k"],
                 f"{b['padding_ratio']:.6f}",
                 f"{sell.get('padding_ratio', 1.0):.6f}", ladder, hack],
            )
