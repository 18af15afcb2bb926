"""Benchmark CLI — the directory-sweep driver (≙ main.c:22-459).

Every hard-coded constant of the reference is a flag (matrix dir main.c:25,
iteration count main.c:20, hack size hll_matrix.h:12, tolerances
main.c:145):

    python -m sparsematrixvectormultiplication_tpu_torch.bench.cli \\
        --matrix-dir ./matrix_for_test --output-dir ./result
    python -m sparsematrixvectormultiplication_tpu_torch.bench.cli \\
        --suite-entry cfd_like --autotune --ladder-sweep

It runs on the CUDA device unless ``--device cpu`` or
``--force-cpu-devices N`` asks for the CPU, and raises when there is none.
It writes the native CSV plus the
reference-compatible openmp/cuda-style CSVs, the bin geometry and the
per-format memory footprint, and resumes a sweep from a checkpoint file (a
capability the reference lacks: its startup wipes result/,
utility.c:200-216). ``--kernels`` takes the port's stage names
(``bench.harness.STAGES``; ``serial_csr`` always runs) or the JAX package's
(``xla_csr``, ``pallas_sell``, ...), so a JAX sweep line runs unchanged.
A matrix that fails prints its traceback and the sweep goes on; the exit
code is then 1. ``--scale-sweep`` adds, per matrix, the row-sharded SELL
SpMV at 1, 2, 4, ... ranks (``bench.scale.run_device_scale_sweep``: one
NCCL rank per GPU) to ``spmv_scale_devices.csv``; ``--force-cpu-devices N``
runs everything on the CPU, that sweep over up to N gloo CPU ranks (the
plain versions), as the JAX flag forces N virtual CPU devices.
"""

# Ported from sparsematrixvectormultiplication_tpu/bench/cli.py (the port
# must not import the JAX package).

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import traceback

import torch

__all__ = ["build_parser", "iter_matrices", "stages_of", "main", "JAX_STAGES"]

# the JAX package's stage names -> the port's (serial_csr runs always)
JAX_STAGES = {
    "xla_csr": "csr", "xla_ell": "ell", "pallas_sell": "sell",
    "pallas_sell_bf16": "sell_bf16", "pallas_sell_dd": "sell_dd",
    "pallas_hll": "hll", "pallas_sell_sigma": "sell_sigma",
    "pallas_pr": "pr", "pallas_pr_dd": "pr_dd", "pallas_split": "split",
    "pallas_split_dd": "split_dd", "pallas_sell_spmm": "sell_spmm",
    "pallas_bsr_spmm": "bsr_spmm",
}


def build_parser():
    p = argparse.ArgumentParser(
        prog="spmv-bench",
        description="SpMV benchmark sweep on the GPU (validating, "
                    "CSV-reporting)",
    )
    src = p.add_mutually_exclusive_group()
    src.add_argument("--matrix-dir", help=".mtx directory to sweep (≙ ../matrix_for_test)")
    src.add_argument("--matrix", action="append", help="single .mtx file (repeatable)")
    src.add_argument(
        "--suite",
        choices=["quick", "full"],
        help="generated synthetic corpus (models/synthetic.py BENCH_SUITE)",
    )
    src.add_argument(
        "--suite-entry", action="append",
        help="single BENCH_SUITE entry by name (repeatable; builds the "
             "matrix in-process — no multi-GB .mtx intermediate)",
    )
    p.add_argument("--output-dir", default="result", help="CSV output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device the stages run on (cuda, cuda:N or "
                        "cpu); the CPU runs the kernels' plain versions")
    p.add_argument("--iterations", type=int, default=20, help="measured reps per stage")
    p.add_argument("--skip", type=int, default=5, help="warm-up iterations (utility.h:7)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
    p.add_argument("--hack-size", type=int, default=32, help="HLL block rows (hll_matrix.h:12)")
    p.add_argument("--abs-tol", type=float, default=1e-5)
    p.add_argument("--rel-tol", type=float, default=1e-4)
    p.add_argument(
        "--kernels",
        default="serial_csr,serial_hll,csr,ell,sell,sell_dd",
        help="comma-separated stage list (the port's names or the JAX "
             "package's)",
    )
    p.add_argument("--spmm-rhs", type=int, default=128,
                   help="RHS columns of the bsr_spmm stage")
    p.add_argument("--sell-spmm-rhs", type=int, default=16,
                   help="RHS columns of the sell_spmm stage (at most 32)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--device-validate", action="store_true",
                   help="per-iteration validation on the device (≙ the "
                        "reference's in-loop checkResult, "
                        "main_cuda.cu:183-188): max|y_i - y_0| over the "
                        "timed reps, one readback; overhead recorded per "
                        "stage")
    p.add_argument("--reorder", default="none", choices=["none", "rcm", "auto"],
                   help="symmetric RCM bandwidth-reducing preprocessing "
                        "(auto = keep only if p98 bandwidth improves >=2x)")
    p.add_argument("--sell-layout", default="auto",
                   choices=["auto", "k-major", "sb-major", "sb-list", "wl",
                            "wl-shed", "sg"],
                   help="force the SELL per-group layout instead of the "
                        "cost model's choice (head-to-head A/B timing)")
    p.add_argument("--chunk-k", type=int, default=0,
                   help="force the sb-major chunk height (bypasses the "
                        "K>64 ck>=16 rule; 0 = auto)")
    p.add_argument("--sell-no-merge", action="store_true",
                   help="keep span/layout sub-bins as separate launches "
                        "instead of cost-model merging (A/B lever)")
    p.add_argument("--autotune", action="store_true",
                   help="pick SELL ladder/layout, bin assembly and HLL hack "
                        "size per matrix: measured on a CUDA device, from "
                        "the host cost model on the CPU "
                        "(≙ cudaOccupancyMaxPotentialBlockSize)")
    p.add_argument("--scale-sweep", action="store_true",
                   help="per matrix, also sweep the device-count axis with the "
                        "row-sharded SELL SpMV (openmp-schema rows, "
                        "num_threads = device count ≙ main.c:18 thread sweep)")
    p.add_argument("--ladder-sweep", action="store_true",
                   help="per matrix, also time every K-bin ladder "
                        "(launch-config axis; native-schema rows)")
    p.add_argument("--force-cpu-devices", type=int, default=0, metavar="N",
                   help="run on the CPU, the device-count sweep over up to N "
                        "gloo CPU ranks (for multi-device sweeps without "
                        "several GPUs)")
    p.add_argument("--resume", action="store_true",
                   help="skip matrices already present in the checkpoint")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace per matrix "
                        "into this dir")
    p.add_argument("--json", action="store_true", help="also print per-matrix JSON lines")
    return p


def stages_of(kernels: str) -> tuple:
    """The harness stages of a ``--kernels`` list, in the harness's order;
    raises ``ValueError`` naming an unknown stage."""
    from .harness import STAGES

    names = {JAX_STAGES.get(k, k) for k in
             (k.strip() for k in kernels.split(",")) if k}
    unknown = sorted(names - set(STAGES) - {"serial_csr"})
    if unknown:
        raise ValueError(f"unknown stages {unknown}; the port runs "
                         f"serial_csr and {STAGES} (or the JAX names "
                         f"{sorted(JAX_STAGES)})")
    return tuple(s for s in STAGES if s in names)


def iter_matrices(args, log=print):
    """Yield (name, builder) pairs — matrices are built LAZILY so resumed
    sweeps skip completed entries without regenerating them."""
    from ..formats.coo import COOMatrix

    if args.suite:
        from ..models.synthetic import BENCH_SUITE

        entries = BENCH_SUITE[:4] if args.suite == "quick" else BENCH_SUITE
        for e in entries:
            yield e.name, e.make
    elif args.suite_entry:
        from ..models.synthetic import BENCH_SUITE

        by_name = {e.name: e for e in BENCH_SUITE}
        # fail loudly: a mistyped entry must not become a 0-matrix sweep
        # that exits 0 inside an unattended chain
        unknown = [nm for nm in args.suite_entry if nm not in by_name]
        if unknown:
            raise SystemExit(
                f"unknown suite entries {unknown}; have {sorted(by_name)}")
        for nm in args.suite_entry:
            yield nm, by_name[nm].make
    elif args.matrix:
        for path in args.matrix:
            yield (os.path.splitext(os.path.basename(path))[0],
                   lambda p=path: COOMatrix.from_mtx(p))
    elif args.matrix_dir:
        files = sorted(glob.glob(os.path.join(args.matrix_dir, "*.mtx")))
        if not files:
            log(f"no .mtx files in {args.matrix_dir}")
        for path in files:
            yield (os.path.splitext(os.path.basename(path))[0],
                   lambda p=path: COOMatrix.from_mtx(p))
    else:
        from ..models.synthetic import BENCH_SUITE

        for e in BENCH_SUITE[:2]:
            yield e.name, e.make


def main(argv=None, *, log=print):
    """Run the sweep; returns the exit code (0, or 1 when a matrix failed).
    ``log`` receives every line the sweep prints but the tracebacks."""
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        stages = stages_of(args.kernels)
    except ValueError as e:
        parser.error(str(e))
    device = torch.device("cpu" if args.force_cpu_devices else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: torch.cuda.is_available() is false, "
            "and the sweep measures on the card; pass --device cpu to run "
            "the plain versions on the CPU")

    from ..utils.profiling import annotate, profile_trace
    from .csv_report import (
        write_cuda_style_row,
        write_memory_stats_row,
        write_native_row,
        write_openmp_style_row,
        write_tile_config_row,
    )
    from .harness import BenchConfig, run_matrix

    cfg = BenchConfig(
        iterations=args.iterations,
        skip=args.skip,
        rounds=args.rounds,
        abs_tol=args.abs_tol,
        rel_tol=args.rel_tol,
        dtype=args.dtype,
        hack_size=args.hack_size,
        stages=stages,
        spmm_rhs=args.spmm_rhs,
        sell_spmm_rhs=args.sell_spmm_rhs,
        validate=not args.no_validate,
        device_validate=args.device_validate,
        autotune=args.autotune,
        reorder=args.reorder,
        sell_layout=args.sell_layout,
        sell_merge_bins=not args.sell_no_merge,
        sell_chunk_k=args.chunk_k,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    ckpt_path = os.path.join(args.output_dir, ".sweep_checkpoint")
    done = set()
    if args.resume and os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            done = set(f.read().split())

    native_csv = os.path.join(args.output_dir, "spmv_results.csv")
    openmp_csv = os.path.join(args.output_dir, "spmv_results_openmp.csv")
    cuda_csv = os.path.join(args.output_dir, "spmv_results_cuda.csv")
    tiles_csv = os.path.join(args.output_dir, "spmv_tile_config.csv")
    # ≙ reference result/matrix_memory_stats_csr.csv (csr_matrix.c:28)
    memstats_csv = os.path.join(args.output_dir, "matrix_memory_stats.csv")

    n_ok = n_fail = 0
    for name, build in iter_matrices(args, log):
        if name in done:
            log(f"[{name}] skipped (checkpoint)")
            continue
        try:
            t0 = time.perf_counter()
            coo = build()
            log(f"[{name}] load/generate: {time.perf_counter()-t0:.1f}s "
                f"({coo.nnz} nnz)")
            with profile_trace(os.path.join(args.profile_dir, name)
                               if args.profile_dir else None), \
                    annotate(f"run_matrix {name}"):
                res = run_matrix(name, coo, cfg, log=log, device=device)
            write_native_row(native_csv, res)
            write_openmp_style_row(openmp_csv, res)
            write_cuda_style_row(cuda_csv, res)
            write_tile_config_row(tiles_csv, res)
            if args.scale_sweep:
                from .scale import run_device_scale_sweep

                run_device_scale_sweep(
                    name, res.csr,
                    os.path.join(args.output_dir, "spmv_scale_devices.csv"),
                    iterations=max(4, args.iterations // 4), log=log,
                    device=device.type,
                    n_devices=args.force_cpu_devices or None,
                )
            if args.ladder_sweep:
                from .scale import run_ladder_sweep

                run_ladder_sweep(
                    name, res.csr,
                    os.path.join(args.output_dir, "spmv_scale_ladders.csv"),
                    iterations=args.iterations, log=log, device=device,
                )
            for fmt in ("csr", "hll", "sell", "sell_sigma"):
                if fmt in res.format_stats:
                    write_memory_stats_row(memstats_csv, name, fmt, res.format_stats[fmt])
            if args.json:
                best = max(
                    (s for s in res.stages.values() if not s.stage.startswith("serial")),
                    key=lambda s: s.gflops,
                    default=None,
                )
                log(json.dumps({
                    "matrix": name, "nnz": res.nnz, "device": res.device,
                    "best_stage": best.stage if best else None,
                    "best_gflops": best.gflops if best else 0.0,
                }))
            with open(ckpt_path, "a") as f:
                f.write(name + "\n")
            n_ok += 1
        except Exception:
            # per-matrix failure continues the sweep (≙ main.c:54-75)
            traceback.print_exc()
            n_fail += 1
    log(f"sweep done: {n_ok} ok, {n_fail} failed -> {args.output_dir}/")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
