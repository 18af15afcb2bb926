"""End-to-end demo: load a .mtx, run every kernel tier, validate, report
(≙ the JAX repo's ``examples/demo.py``).

    python -m sparsematrixvectormultiplication_tpu_torch.demo [matrix.mtx] [--device cpu]

Without a path it generates ``banded(50_000, 24, 500, seed=0)``. It runs on
the card (``--device cpu``: the kernels' plain versions on the CPU) and
stops when CUDA is absent. Each tier is held against the host fp64 oracle
with ``utils.validation.difference_metrics``, in the JAX demo's order: SELL
f32, double-double SELL with an fp64 x, BSR SpMM at B=8, bf16 SELL (against
the oracle of the bf16-quantized matrix), k-major SELL SpMM at R=8,
mixed-precision iterative refinement (bf16 inner CG) on a 1024-row SPD
tridiagonal, Chebyshev(4) PCG beside plain CG over the plain CSR matvec,
PageRank on |A| when A is square, and ``choose_format`` /
``auto_device_op``. On the card it ends with the SELL f32 kernel's device
time. The exit code is 1 when a tier shows a significant difference or the
refinement misses ``REFINE_TOL`` (:func:`exit_code`), else 0.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

__all__ = ["run", "exit_code", "main", "REFINE_TOL"]

REFINE_TOL = 1e-11   # the refinement's relative residual, as the JAX demo's
BSR_MAX_BYTES = 256 << 20
RHS = 8


def exit_code(diffs: dict, refine_residual: float) -> int:
    """1 when a tier of ``diffs`` (tier -> significant_diffs) is non-zero or
    the refinement's final relative residual is above :data:`REFINE_TOL`
    (or not a number), else 0."""
    if any(n != 0 for n in diffs.values()):
        return 1
    return 0 if refine_residual <= REFINE_TOL else 1


def _tridiagonal_spd(n: int):
    """The JAX demo's SPD tridiagonal [-1, 6, -1] of ``n`` rows."""
    from .formats.coo import COOMatrix
    from .formats.csr import CSRMatrix

    rows = np.repeat(np.arange(n), 3)[1:-1]
    cols = rows + np.tile([-1, 0, 1], n)[1:-1]
    keep = (cols >= 0) & (cols < n)
    return CSRMatrix.from_coo(COOMatrix(
        n, n, rows[keep].astype(np.int64), cols[keep].astype(np.int64),
        np.tile([-1.0, 6.0, -1.0], n)[1:-1][keep]))


def run(coo, name: str, device, log=print) -> dict:
    """Every tier on ``coo`` on ``device``; returns ``diffs`` (tier ->
    significant_diffs; the BSR tier is absent when the host's block budget
    refuses the matrix) and ``refinement`` (the final relative residual)."""
    from .bench.harness import quantize_bf16
    from .entry import device_or_raise
    from .formats.bsr import BSRMatrix
    from .formats.coo import COOMatrix
    from .formats.csr import CSRMatrix
    from .formats.sell import SellMatrix
    from .ops import (auto_device_op, bsr_spmm, choose_format, csr_spmv,
                      device_put_bsr, device_put_csr, device_put_sell,
                      device_put_sell_dd, device_put_x, device_put_x_multi,
                      pack_x_table, pad_rhs, sell_spmv, sell_spmv_dd_f64)
    from .ops.sell_spmm import sell_spmm
    from .solvers import (cg, chebyshev_preconditioner, gershgorin_bounds,
                          iterative_refinement, pagerank, pagerank_operator)
    from .utils.metrics import format_flops
    from .utils.timing import device_time_fn
    from .utils.validation import difference_metrics

    device = device_or_raise(device)
    diffs = {}

    def tier(key, label, ref, y, note=""):
        dm = difference_metrics(ref, y)
        diffs[key] = dm.significant_diffs
        log(f"{label}: significant_diffs={dm.significant_diffs} "
            f"max_rel={dm.max_rel_err:.2e}{note}")

    def host(t):
        return t.double().cpu().numpy()

    log(f"matrix: {name} -> {coo.summary()}")
    csr = CSRMatrix.from_coo(coo)
    sell = SellMatrix.from_csr(csr)
    st = sell.memory_stats()
    log(f"SELL layout: {st['num_bins']} bins {st['bin_ks']} "
        f"({st['bin_layouts']}), padding {st['padding_ratio']:.2f}x")
    x = np.ones(coo.ncols)
    y_oracle = csr.spmv(x)
    log(f"device: {torch.cuda.get_device_name(device)}"
        if device.type == "cuda" else "device: cpu (plain versions)")

    # f32 SELL
    d32 = device_put_sell(sell, dtype=torch.float32, device=device)
    xt = device_put_x(x, coo.ncols, device=device)
    tier("SELL f32", "SELL f32", y_oracle, host(sell_spmv(d32, xt)))

    # fp64-class double-double SELL
    ddd = device_put_sell_dd(sell, device=device)
    tier("SELL dd", "SELL fp64dd", y_oracle, host(sell_spmv_dd_f64(
        ddd, torch.from_numpy(x).to(device))))
    del ddd

    # BSR SpMM: clustered/banded matrices only; the host's block budget
    # refuses scattered ones, which stay on the tiers above
    try:
        bsr = BSRMatrix.from_csr(csr, max_bytes=BSR_MAX_BYTES)
    except ValueError as e:
        if "budget" not in str(e):
            raise
        log(f"BSR SpMM: skipped ({str(e)[:80]}...)")
    else:
        dbsr = device_put_bsr(bsr, device=device)
        X = np.random.default_rng(0).standard_normal((coo.ncols, RHS),
                                                     dtype=np.float32)
        Y = bsr_spmm(dbsr, pad_rhs(X, coo.ncols, device=device))[:, :RHS]
        tier("BSR SpMM", f"BSR SpMM (B={RHS}, fill {bsr.fill:.3f})",
             csr.spmv(X[:, 0].astype(np.float64)), host(Y[:, 0]))
        del dbsr, bsr

    # bf16 value planes, f32 sums: against the oracle of the bf16-quantized
    # matrix
    dbf = device_put_sell(sell, dtype=torch.bfloat16, device=device)
    csr_q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                      quantize_bf16(csr.values))
    tier("SELL bf16", "SELL bf16", csr_q.spmv(x), host(sell_spmv(dbf, xt)),
         " (vs bf16-quantized oracle)")
    del dbf

    # multi-RHS SELL SpMM: A streamed once for 8 right-hand sides
    sell_km = SellMatrix.from_csr(csr, layout="k-major")
    dkm = device_put_sell(sell_km, dtype=torch.float32, device=device)
    Xmm = np.random.default_rng(1).standard_normal((coo.ncols, RHS))
    Ymm = sell_spmm(dkm, device_put_x_multi(Xmm, coo.ncols, device=device))
    ymm_ref = csr.spmv(Xmm[:, 3])
    if sell_km.row_perm is not None:
        ymm_ref = ymm_ref[sell_km.row_perm]
    tier("SELL SpMM", f"SELL SpMM (R={RHS})", ymm_ref, host(Ymm[:, 3]))
    del dkm

    # mixed-precision refinement: bf16 inner CG, fp64 host residuals (an
    # SPD tridiagonal of its own: the demo matrix is nonsymmetric)
    n_ir = 1024
    ir_csr = _tridiagonal_spd(n_ir)
    ir_dbf = device_put_sell(SellMatrix.from_csr(ir_csr, layout="k-major"),
                             dtype=torch.bfloat16, device=device)

    def ir_inner(r):
        xx, _, _ = cg(lambda v: sell_spmv(ir_dbf, pack_x_table(v, n_ir)),
                      torch.from_numpy(r).to(device, torch.float32),
                      tol=1e-2, maxiter=60)
        return host(xx)

    _, sweeps, resnorms = iterative_refinement(
        ir_inner, ir_csr.spmv, np.ones(n_ir), tol=REFINE_TOL, max_sweeps=8)
    log(f"refinement (bf16 inner CG): {sweeps} sweeps, rel residual "
        f"{resnorms[-1]:.1e} (limit {REFINE_TOL:.0e})")

    # Chebyshev-preconditioned CG on the same matrix: degree - 1 extra
    # matvecs a step, no triangular solves
    ir_dc = device_put_csr(ir_csr, dtype=torch.float32, device=device)

    def ir_mv(v):
        return csr_spmv(ir_dc.values, ir_dc.col_idx, ir_dc.row_ids, v,
                        nrows=ir_dc.nrows)

    lmin, lmax = gershgorin_bounds(ir_csr)
    b_ir = torch.ones(n_ir, dtype=torch.float32, device=device)
    _, it_c, _ = cg(ir_mv, b_ir, tol=1e-5, maxiter=500,
                    prec=chebyshev_preconditioner(ir_mv, lmin, lmax,
                                                  degree=4))
    _, it_p, _ = cg(ir_mv, b_ir, tol=1e-5, maxiter=500)
    log(f"Chebyshev(4) PCG: {int(it_c)} iters vs plain CG {int(it_p)}")

    # PageRank on |A| over the plain CSR matvec, iterated in fp64: in f32
    # the card's index_add_ adds in another order every step, and the L1
    # step stalls near 3e-8, above the 1e-10 tolerance
    if coo.nrows == coo.ncols:
        t, dangling = pagerank_operator(CSRMatrix.from_coo(COOMatrix(
            coo.nrows, coo.ncols, coo.row, coo.col, np.abs(coo.val))))
        dt_pr = device_put_csr(t, device=device)
        p, iters, delta = pagerank(
            lambda u: csr_spmv(dt_pr.values, dt_pr.col_idx, dt_pr.row_ids,
                               u, nrows=dt_pr.nrows),
            torch.from_numpy(dangling).to(device, torch.float64), tol=1e-10,
            maxiter=200)
        log(f"PageRank: {iters} iterations, L1 delta {float(delta):.2e}, "
            f"sum={float(p.sum()):.6f}")

    # automatic format selection
    kind, astats = choose_format(csr)
    log(f"auto format: {kind} ({astats.get('reason')})")
    op = auto_device_op(csr, device=device)
    tier("auto", f"auto matvec ({op.kind})", y_oracle, op.matvec(x))

    if device.type == "cuda":
        sec = device_time_fn(sell_spmv, d32, xt, device=device)
        log(f"SELL f32 time on {torch.cuda.get_device_name(device)}: "
            f"{sec * 1e3:.4f} ms = {format_flops(2 * coo.nnz / sec)}")
    else:
        log("SELL f32 time: not measured (device time is taken on the card)")
    return {"diffs": diffs, "refinement": resnorms[-1]}


def main(argv=None, *, log=print) -> int:
    """Run the demo; returns :func:`exit_code` of its tiers."""
    p = argparse.ArgumentParser(
        prog="python -m sparsematrixvectormultiplication_tpu_torch.demo",
        description="every kernel tier on one matrix, validated")
    p.add_argument("mtx", nargs="?", help="a Matrix Market file (default: "
                   "banded(50_000, 24, 500, seed=0))")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    if args.mtx:
        from .formats.coo import COOMatrix

        coo = COOMatrix.from_mtx(args.mtx)
        name = os.path.basename(args.mtx)
    else:
        from .models.synthetic import banded

        coo = banded(50_000, 24, 500, seed=0)
        name = "banded_demo(50k x 50k, ~24 nnz/row)"
    res = run(coo, name, args.device, log=log)
    code = exit_code(res["diffs"], res["refinement"])
    if code:
        log(f"demo FAILED: significant diffs {res['diffs']}, refinement "
            f"residual {res['refinement']:.1e}")
    return code


if __name__ == "__main__":
    sys.exit(main())
