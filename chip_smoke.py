#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main paths on one GPU: SELL SpMV
(f32, bf16 and double-double), the PR layout and the locality split (f32
and double-double), and ``auto_device_op``.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``csrc/`` and the PR router from
``native/``, then drives the main path (generate or read a matrix -> CSR ->
layout -> upload -> SpMV, validated against the fp64 oracle) through
``run_matrix`` on eight phases, each of which must convert to exactly the
SELL bin layouts named beside it:

* entry:              banded(8192, 24, 512): k-major;
* mixed:              fem_3d(20, 20, 20, dof=3): k-major and wl in one matrix;
* mtx:                a banded matrix written as Matrix Market and read back;
* headline:           fem_3d(60, 60, 60, dof=3), bench.py's fem3d_cube: wl;
* banded_adversarial: banded(250_000, 60, 2500), bench.py's: sb-major;
* road_scattered:     road_network(1_200_000), bench.py's road: sb-list; also
                      the ``split`` and ``split_dd`` stages, which must give
                      slab_dist 1, a far side of one 16,384-row PR problem
                      with one K=1 bin and a k-major near side, and launch
                      the PR and k-major kernels of both precisions;
* scattered_uniform:  random_general(200_000, 200_000, 2.5e-4), the suite's
                      random_uniform: sg (static and dynamic window tables)
                      plus accumulating (add_into) k-major far bins;
* webbase_pr:         webbase_like(1_000_000, 3), the suite's webbase_like:
                      SELL k-major and sg, and the ``pr`` and ``pr_dd``
                      stages on 2 PR panels of 16,384 Beneš rows;

and then a panel phase: fem_3d(10, 10, 10, dof=3) split into 1024-column
panels (k-major and wl bins) through ``panel_sell_spmv``, every bin
accumulating; and ``auto_device_op`` on the mixed and road_scattered
matrices and on power_law(200_000, 3), which must pick "sell", "split" and
"pr" and whose ``matvec`` must launch the kernels of what it picked.

Every stage and every ``matvec`` must show no significant difference from
the fp64 oracle (bf16: the oracle of the bf16-quantized matrix); the dd
stages also a norm-scaled error ``max|y - y_ref| / max|y_ref|`` below
1e-12. The SELL phases run f32, bf16 and dd (``sell_dd``; scattered_uniform's
slot-packed sg bins are rebuilt in rows mode for it), webbase_pr only f32.
The kernels' launch counters are reset before the phases and read after
them and the panel phase, before ``auto_device_op``; every kernel and every
dd kernel, and the k-major kernel of both precisions in accumulate mode,
must have been launched.

Then every bin of every phase, banded_adversarial and road_scattered also
with int16 sb index planes, is run through its kernel, storing and
accumulating, and through its plain PyTorch version on the card; they must
agree within rtol=1e-5, atol=1e-5*max|y| (f32 sums in another order), or
for the dd kernels within 1e-12*max|y| on the fp64-combined result (dd sums
in another order). So are webbase_pr's PR panels through the PR and
PR-dd kernels, and road_scattered's split (its K=1 far problem through the
PR kernels, and the composite). Kernel and plain version are each timed
twice: device time (CUDA events around calls queued back to back behind a
spin kernel, per call) and call time (CUDA events around each call, host
included). Beside each phase's SpMV, the
device time of cuSPARSE's CSR SpMV (``torch.sparse_csr_tensor @ x``) on the
phase's whole matrix, f32 values beside the f32/bf16 kernels and fp64
beside the dd kernels, is printed; it is a yardstick only, which no module
of the port calls.

The JSON summary's ``ms`` and ``plain_ms`` are device times, at each
kernel's main-path bin with the most entries (PR: webbase_pr's panel 0) with f32 (or dd)
values and int32 index planes; ``bound_ms`` is the least time the card could
take for the function that bin computes: its real entries' values and 4 B
columns, each distinct x entry (per x table) they read and each y row they
write, moved once, over 3.35 TB/s (SpMV does ~2 FLOP per entry f32, ~20 dd,
so bytes bind). Padding, index tables and the layout's own planes are not
counted; the bytes the layout's planes hold are printed beside it.
``library_ms`` is the cuSPARSE time of the bin's phase.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before them;
so does a machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SEED = 0
RTOL = 1e-5
ATOL_REL = 1e-5  # atol = ATOL_REL * max|y_plain|
DD_TOL = 1e-12   # dd: kernel vs plain, times max|y|; norm-scaled error
# a plain dd call queues 80-200 small kernels, a plain PR call ~200 (f32)
# or ~500 (dd); device_time_fn queues its reps behind one spin, and more
# than the stream's launch queue holds would block the host until the spin
# ends
PLAIN_DD_REPS = 3
PLAIN_PR_REPS = 2
PLAIN_PR_DD_REPS = 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
PKG = "sparsematrixvectormultiplication_tpu_torch"
TPU = "sparsematrixvectormultiplication_tpu/ops/pallas_sell.py"
KERNELS = {
    # layout: (name, source, TPU kernel replaced)
    "k-major": ("sell_k_major", f"{PKG}/csrc/sell_k_major.cu", f"{TPU}:614"),
    "wl": ("sell_wl", f"{PKG}/csrc/sell_wl.cu", f"{TPU}:863"),
    "sb-major": ("sell_sb_major", f"{PKG}/csrc/sell_sb.cu", f"{TPU}:721"),
    "sb-list": ("sell_sb_list", f"{PKG}/csrc/sell_sb.cu", f"{TPU}:810"),
    "sg": ("sell_sg", f"{PKG}/csrc/sell_sg.cu", f"{TPU}:917"),
}
TPU_DD = "sparsematrixvectormultiplication_tpu/ops/pallas_sell_dd.py"
DD_KERNELS = {
    "k-major": ("sell_k_major_dd", f"{PKG}/csrc/sell_k_major.cu",
                f"{TPU_DD}:329"),
    "wl": ("sell_wl_dd", f"{PKG}/csrc/sell_wl.cu", f"{TPU_DD}:422"),
    "sb-major": ("sell_sb_major_dd", f"{PKG}/csrc/sell_sb.cu",
                 f"{TPU_DD}:208"),
    "sb-list": ("sell_sb_list_dd", f"{PKG}/csrc/sell_sb.cu", f"{TPU_DD}:274"),
    "sg": ("sell_sg_dd", f"{PKG}/csrc/sell_sg.cu", f"{TPU_DD}:490"),
}
PR_KERNELS = {
    "pr": ("pr_spmv_f32", f"{PKG}/csrc/pr.cu",
           "sparsematrixvectormultiplication_tpu/ops/pallas_pr.py:150"),
    "pr_dd": ("pr_spmv_dd", f"{PKG}/csrc/pr.cu",
              "sparsematrixvectormultiplication_tpu/ops/pallas_pr_dd.py:114"),
}
SB_I16_PHASES = ("banded_adversarial", "road_scattered")
SELL_STAGES = ("sell", "sell_bf16", "sell_dd")
DD_STAGES = ("sell_dd", "pr_dd", "split_dd")
PR_ROWS = 1 << 14  # the host PR problems' Beneš rows (a TPU VMEM cap)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def mtx_roundtrip(make_coo, read_coo, write):
    coo = make_coo()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "banded.mtx")
        write(path, coo.nrows, coo.ncols, coo.row, coo.col, coo.val)
        back = read_coo(path)
    if not (back.shape == coo.shape and np.array_equal(back.row, coo.row)
            and np.array_equal(back.col, coo.col)
            and np.array_equal(back.val, coo.val)):
        fail("Matrix Market round trip changed the matrix")
    return back


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sparsematrixvectormultiplication_tpu_torch import (
        COOMatrix, CSRMatrix, PanelPRMatrix, PanelSellMatrix, PRMatrix,
        auto_device_op, run_matrix)
    from sparsematrixvectormultiplication_tpu_torch.bench.harness import (
        BenchConfig, quantize_bf16)
    from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
        write_matrix_market)
    from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
        banded, fem_3d, power_law, random_general, road_network,
        webbase_like)
    from sparsematrixvectormultiplication_tpu_torch.native import (
        build as native_build)
    from sparsematrixvectormultiplication_tpu_torch.ops import _build
    from sparsematrixvectormultiplication_tpu_torch.ops import pr as PR
    from sparsematrixvectormultiplication_tpu_torch.ops import pr_dd as PRD
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
    from sparsematrixvectormultiplication_tpu_torch.ops import split as SPL
    from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
        combine_f64, dd_add_dd, split_f64)
    from sparsematrixvectormultiplication_tpu_torch.utils.metrics import (
        calculate_flops)
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn, time_fn)
    from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
        difference_metrics)

    if "jax" in sys.modules:
        fail("the port imported jax")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{_build.library_path().name}")
    print(_build.build_log().strip())
    t0 = time.perf_counter()
    native_build.load_fast_route()
    print(f"PR router built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{native_build.library_path().name}")

    def need_ms(nnz, value_bytes, n_x, n_y, tables):
        """The least time of an SpMV piece: ``nnz`` entries of
        ``value_bytes`` plus a 4 B column, ``n_x`` distinct x entries and
        ``n_y`` y rows per x table (``tables``: 2 for dd), over the HBM
        rate."""
        moved = nnz * (value_bytes + 4) + (n_x + n_y) * 4 * tables
        return moved / HBM_BYTES_PER_S * 1e3

    used_cols = {}

    def csr_bound_ms(csr, value_bytes, tables):
        """The whole matrix's SpMV: every entry, every column it reads, every
        row of y."""
        if id(csr) not in used_cols:
            used_cols[id(csr)] = int(np.unique(csr.col_idx).size)
        return need_ms(csr.nnz, value_bytes, used_cols[id(csr)], csr.nrows,
                       tables)

    # name, matrix, the SELL layouts its conversion must hold, stages
    phases = [
        ("entry", lambda: banded(8192, 24, 512, seed=0), {"k-major"},
         SELL_STAGES),
        ("mixed", lambda: fem_3d(20, 20, 20, dof=3, seed=1),
         {"k-major", "wl"}, SELL_STAGES),
        ("mtx", lambda: mtx_roundtrip(lambda: banded(6000, 16, 400, seed=2),
                                      COOMatrix.from_mtx,
                                      write_matrix_market), {"k-major"},
         SELL_STAGES),
        ("headline", lambda: fem_3d(60, 60, 60, dof=3, seed=1), {"wl"},
         SELL_STAGES),
        ("banded_adversarial", lambda: banded(250_000, 60, 2500, seed=1),
         {"sb-major"}, SELL_STAGES),
        ("road_scattered", lambda: road_network(1_200_000, seed=1),
         {"sb-list"}, (*SELL_STAGES, "split", "split_dd")),
        ("scattered_uniform",
         lambda: random_general(200_000, 200_000, 2.5e-4, seed=8),
         {"sg", "k-major"}, SELL_STAGES),
        ("webbase_pr", lambda: webbase_like(1_000_000, 3, seed=9),
         {"k-major", "sg"}, ("sell", "pr", "pr_dd")),
    ]
    wrappers = S._KERNEL
    plains = S._PLAIN
    dd_wrappers = D._KERNEL_DD
    dd_plains = D._PLAIN_DD
    pr_wrappers = {"pr": PR.pr_problem, "pr_dd": PRD.pr_problem_dd}

    def counts(ws=wrappers):
        return {lay: w.launches for lay, w in ws.items()}

    def check_pr(name, res):
        """The webbase_pr phase's PR product: 2 panels of 16,384 rows."""
        pr = res.pr
        rows = [p.n_rows for p in getattr(pr, "panels", ())]
        if not isinstance(pr, PanelPRMatrix) or rows != [PR_ROWS, PR_ROWS]:
            fail(f"{name}: the PR conversion gave {type(pr).__name__} with "
                 f"Beneš rows {rows or pr.n_rows}, not 2 x {PR_ROWS}")

    def check_split(name, res):
        """road_scattered's split: slab_dist 1, one 16,384-row K=1 far
        problem, a k-major near side."""
        sm = res.split
        if sm is None:
            fail(f"{name}: no split ({res.skipped})")
        near = {b.layout for b in sm.near.bins}
        far = sm.far
        if (sm.slab_dist != 1 or not isinstance(far, PRMatrix)
                or far.n_rows != PR_ROWS or len(far.bins) != 1
                or far.bins[0][0] != 1 or near != {"k-major"}):
            fail(f"{name}: the split gave slab_dist {sm.slab_dist}, far "
                 f"{type(far).__name__} {getattr(far, 'bins', None)}, near "
                 f"layouts {sorted(near)}")
        near_bins = [(b.layout, b.k, b.n_groups) for b in sm.near.bins]
        return (f"; split slab_dist {sm.slab_dist}, far fraction "
                f"{sm.far_frac:.4f}, far {far.n_rows} rows bins {far.bins}, "
                f"near bins {near_bins}")

    # ---- the main path; the launch counts are read from this run only ----
    for w in (*wrappers.values(), *dd_wrappers.values(),
              *pr_wrappers.values()):
        w.launches = 0
        w.accumulating = 0
    runs = []
    phase_csr = {}
    web = road = None
    for name, make, layouts, stages in phases:
        t0 = time.perf_counter()
        coo = make()
        x = np.random.default_rng(SEED).standard_normal(coo.ncols)
        before = (counts(), counts(dd_wrappers), counts(pr_wrappers))
        res = run_matrix(name, coo, BenchConfig(stages=stages), x=x,
                         device=dev, log=lambda m: print(m, flush=True))
        bins = res.sell.bins
        got = {b.layout for b in bins}
        if got != layouts:
            fail(f"{name}: the conversion gave layouts {sorted(got)}, "
                 f"the phase exists to run {sorted(layouts)}")
        got_dd = set()
        if "sell_dd" in stages:
            # sell_dd runs the same SELL, or its rows-mode rebuild where the
            # conversion has slot-packed sg bins (the far bins may then go)
            got_dd = {b.layout for b in res.sell_dd.bins}
            if res.sell_dd is res.sell:
                ok_dd = got_dd == layouts
            else:
                ok_dd = "sg" in got_dd and got_dd <= layouts
            if not ok_dd:
                fail(f"{name}: the sell_dd conversion gave layouts "
                     f"{sorted(got_dd)}")
        if name == "scattered_uniform" and not (
                any(b.add_into for b in bins)
                and {b.span > 0 for b in bins if b.layout == "sg"}
                == {True, False}):
            fail(f"{name}: no add_into far bins, or not both static and "
                 "dynamic sg bins")
        if tuple(res.stages) != ("serial_csr", *stages):
            fail(f"{name}: ran {tuple(res.stages)} ({res.skipped})")
        for stage in stages:
            sig = res.stages[stage].diff.significant_diffs
            if sig:
                fail(f"{name} {stage}: {sig} significant diffs vs the oracle")
        dd_errs = {s: res.stages[s].norm_err for s in stages
                   if s in DD_STAGES}
        for stage, err in dd_errs.items():
            if not err < DD_TOL:
                fail(f"{name} {stage}: norm-scaled error {err:.3e} >= "
                     f"{DD_TOL}")
        now = (counts(), counts(dd_wrappers), counts(pr_wrappers))
        # the SELL layouts of f32 (and dd) and, for the PR and split
        # stages, the PR kernels and the split's k-major near side
        want = [(0, lay) for lay in layouts] + [(1, lay) for lay in got_dd]
        if "pr" in stages:
            check_pr(name, res)
            want += [(2, "pr"), (2, "pr_dd")]
        extra = ""
        if "split" in stages:
            extra = check_split(name, res)
            want += [(2, "pr"), (2, "pr_dd"), (0, "k-major"), (1, "k-major")]
        for which, lay in want:
            if now[which][lay] <= before[which][lay]:
                fail(f"{name}: the {lay}{' dd' if which == 1 else ''} "
                     "kernel was not launched")
        if res.pr is not None:
            extra += (f"; PR panels {[p.n_rows for p in res.pr.panels]} "
                      f"bins {[p.bins for p in res.pr.panels]}, padding "
                      f"{res.pr.padding_ratio:.3f}")
        shapes = [[(b.layout, b.k, b.n_groups, b.span) for b in s.bins]
                  for s in (res.sell, res.sell_dd) if s is not None]
        per_call = {s: round(res.stages[s].seconds * 1e3, 4)
                    for s in stages}
        print(f"[{name}] {coo.nrows} rows, {coo.nnz} nnz, bins {shapes}, "
              f"padding {res.sell.padding_ratio:.3f}; ms per call "
              f"{per_call}; norm-scaled errors "
              f"{ {s: f'{e:.3e}' for s, e in dd_errs.items()} }{extra}; "
              f"phase {time.perf_counter() - t0:.1f} s", flush=True)
        runs.append((name, res.sell, res.sell_dd, x, res.csr))
        phase_csr[name] = res.csr
        if name == "webbase_pr":
            web = (res.pr, x, res.csr)
        if res.split is not None:
            road = (res.split, x, res.csr)

    # the panel phase: column panels through panel_sell_spmv
    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(fem_3d(10, 10, 10, dof=3, seed=0))
    psell = PanelSellMatrix.from_csr(csr, max_panel_cols=1024)
    got = {b.layout for p in psell.panels for b in p.bins}
    if len(psell.panels) < 3 or got != {"k-major", "wl"}:
        fail(f"panels: {len(psell.panels)} panels of layouts {sorted(got)}")
    x = np.random.default_rng(SEED).standard_normal(csr.ncols)
    x32 = x.astype(np.float32)
    before = {lay: w.accumulating for lay, w in wrappers.items()}
    before_dd = {lay: w.accumulating for lay, w in dd_wrappers.items()}
    for dtype, vals in ((torch.float32, csr.values),
                        (torch.bfloat16, quantize_bf16(csr.values))):
        y = S.panel_sell_spmv(S.device_put_sell(psell, dtype, device=dev),
                              torch.from_numpy(x32).to(dev))
        ref = type(csr)(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                        vals).spmv(x32.astype(np.float64))
        sig = difference_metrics(ref, y.cpu().numpy().astype(
            np.float64)).significant_diffs
        if sig:
            fail(f"panels {dtype}: {sig} significant diffs vs the oracle")
    xh, xl = (torch.from_numpy(h).to(dev) for h in split_f64(x))
    y = combine_f64(*D.panel_sell_spmv_dd(D.device_put_sell_dd(
        psell, device=dev), xh, xl)).cpu().numpy()
    ref = csr.spmv(x)
    sig = difference_metrics(ref, y).significant_diffs
    dd_err = float(np.abs(y - ref).max() / np.abs(ref).max())
    if sig or not dd_err < DD_TOL:
        fail(f"panels dd: {sig} significant diffs, norm-scaled error "
             f"{dd_err:.3e}")
    for lay in got:
        if wrappers[lay].accumulating <= before[lay]:
            fail(f"panels: the {lay} kernel did not accumulate")
        if dd_wrappers[lay].accumulating <= before_dd[lay]:
            fail(f"panels: the {lay} dd kernel did not accumulate")
    print(f"[panels] {csr.nrows} rows, {csr.nnz} nnz, "
          f"{len(psell.panels)} panels, bins "
          f"{[[(b.layout, b.k, b.n_groups) for b in p.bins] for p in psell.panels]}, "
          f"dd norm-scaled error {dd_err:.3e}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    launches, launches_dd = counts(), counts(dd_wrappers)
    launches_pr = counts(pr_wrappers)
    for tag, ws, ls in (("", wrappers, launches),
                        (" dd", dd_wrappers, launches_dd)):
        for lay, n in ls.items():
            if n == 0:
                fail(f"the {lay}{tag} kernel was never launched on the main "
                     "path")
        if ws["k-major"].accumulating == 0:
            fail(f"the k-major{tag} kernel never accumulated on the main path")
        print(f"main-path{tag} launches {ls}, accumulating "
              f"{ {lay: w.accumulating for lay, w in ws.items()} }",
              flush=True)
    for kind, n in launches_pr.items():
        if n == 0:
            fail(f"the {kind} kernel was never launched on the main path")
    print(f"main-path PR launches {launches_pr}", flush=True)

    # auto_device_op: one call from a CSR to a validated matvec, which must
    # launch the kernels of the layout it picked
    auto_cases = [("mixed", phase_csr["mixed"], "sell"),
                  ("road_scattered", phase_csr["road_scattered"], "split"),
                  ("power_law", CSRMatrix.from_coo(
                      power_law(200_000, 3, seed=6)), "pr")]
    for name, acsr, kind in auto_cases:
        t0 = time.perf_counter()
        op = auto_device_op(acsr, device=dev)
        if op.kind != kind:
            fail(f"auto on {name}: picked {op.kind}, not {kind} "
                 f"({op.stats})")
        sell_bins = (op.host.bins if kind == "sell" else
                     op.host.near.bins if kind == "split" else ())
        want = {("pr", "pr")} if kind != "sell" else set()
        want |= {("sell", b.layout) for b in sell_bins}
        x = np.random.default_rng(SEED).standard_normal(acsr.ncols)
        ref = acsr.spmv(x)
        before = {"sell": counts(), "pr": counts(pr_wrappers)}
        y = op.matvec(x)
        after = {"sell": counts(), "pr": counts(pr_wrappers)}
        dm = difference_metrics(ref, y)
        if dm.significant_diffs:
            fail(f"auto on {name}: {dm.significant_diffs} significant diffs")
        idle = sorted(f"{g} {k}" for g, k in want
                      if after[g][k] <= before[g][k])
        if idle:
            fail(f"auto on {name} ({kind}): kernels {idle} were not launched")
        print(f"[auto {name}] {acsr.nrows} rows, {acsr.nnz} nnz: {op.kind} "
              f"({op.stats.get('reason')}), kernels launched "
              f"{sorted(f'{g} {k}' for g, k in want)}, max_rel "
              f"{dm.max_rel_err:.2e}; {time.perf_counter() - t0:.1f} s",
              flush=True)

    # ---- cuSPARSE's CSR SpMV on each phase's matrix: the yardstick ----
    library = {}

    def lib_note(name, csr, x, dtype):
        """Device ms of ``torch.sparse_csr_tensor(...) @ x`` (cuSPARSE) on
        the whole matrix, and its max error against the fp64 oracle; timed
        once per phase and value type."""
        if (name, dtype) not in library:
            library[name, dtype] = cusparse(csr, x, dtype)
        ms, err = library[name, dtype]
        return (f"; cuSPARSE {str(dtype)[6:]} {ms:.4f} ms (max|y-y_ref| "
                f"{err:.2e})")

    def cusparse(csr, x, dtype):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(
                torch.from_numpy(csr.row_ptr.astype(np.int32)),
                torch.from_numpy(csr.col_idx.astype(np.int32)),
                torch.from_numpy(csr.values).to(dtype), size=csr.shape,
                device=dev, check_invariants=False)
            xv = torch.from_numpy(x).to(dtype).to(dev)
            err = float(np.abs((A @ xv).cpu().double().numpy()
                               - csr.spmv(x)).max())
            return device_time_fn(lambda: A @ xv, device=dev) * 1e3, err

    # ---- every kernel against its plain version, on the card ----
    stats = {lay: {"max_abs_err": 0.0, "best": None} for lay in wrappers}
    stats_dd = {lay: {"max_abs_err": 0.0, "best": None}
                for lay in dd_wrappers}

    def value_planes(b):
        return (b.as_hi, b.as_lo) if hasattr(b, "as_hi") else (b.as_,)

    def device_bytes(d):
        return sum(t.numel() * t.element_size() for b in d.bins
                   for t in (b.ja, *value_planes(b), b.slab_list,
                             b.slab_count, b.group_ids))

    def bytes_read(b):
        """Bytes a kernel streams: its planes (an sg bin reads only its
        groups' real tiles) and its tables."""
        planes = sum(t.numel() * t.element_size()
                     for t in (b.ja, *value_planes(b)))
        if b.layout == "sg":
            real = int(b.slab_count.clamp(max=b.k).sum())
            planes = planes * real // (b.n_groups * b.k)
        return planes + sum(t.numel() * t.element_size()
                            for t in (b.slab_list, b.slab_count, b.group_ids))

    def bound_ms(b, xs):
        """The least time of the bin's function: its real entries (a value
        that is not 0, in a slot its layout does not mask), the distinct x
        entries they read and the y rows they write (those the plain version
        sums from a value plane of 1s at 1s of x); returns it and the bin's
        real entries."""
        shape, cols, keep, _ = S._SLOTS[b.layout](b)
        vals = value_planes(b)
        real = vals[0].view(shape) != 0
        if keep is not None:
            real = real & keep
        n_x = int(torch.unique(cols[real]).numel())
        index = {f.name: getattr(b, f.name)
                 for f in dataclasses.fields(S.DeviceBinIndex)}
        ones = S.DeviceSellBin(**index,
                               as_=real.float().reshape(vals[0].shape))
        n_y = int((plains[b.layout](ones, torch.ones_like(xs[0])) > 0).sum())
        nnz = int(real.sum())
        return need_ms(nnz, sum(v.element_size() for v in vals), n_x, n_y,
                       len(xs)), nnz

    def check_bin(tag, b, xt, y0, phase):
        want = plains[b.layout](b, xt)
        atol = ATOL_REL * float(want.abs().max())
        rows = b.group_ids.long()
        err = 0.0
        for accumulate in (False, True):
            y = y0.clone()
            wrappers[b.layout](b, xt, y, accumulate=accumulate)
            got = y.view(-1, 8, 128)[rows]
            if accumulate:
                got = got - y0.view(-1, 8, 128)[rows]
            e = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=RTOL, atol=atol):
                fail(f"{tag} ({b.layout}, accumulate={accumulate}): "
                     f"max|k-p| = {e}")
            err = max(err, e)
        st = stats[b.layout]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        y = y0.clone()
        ms_k = device_time_fn(wrappers[b.layout], b, xt, y, device=dev) * 1e3
        ms_p = device_time_fn(plains[b.layout], b, xt, device=dev) * 1e3
        call_k = time_fn(wrappers[b.layout], b, xt, y, device=dev) * 1e3
        call_p = time_fn(plains[b.layout], b, xt, device=dev) * 1e3
        bound, nnz = bound_ms(b, (xt,))
        print(f"{tag} {b.layout} k={b.k} groups={b.n_groups} span={b.span} "
              f"ja={str(b.ja.dtype)[6:]}{' add_into' if b.add_into else ''}: "
              f"device kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms; call "
              f"kernel {call_k:.4f} ms, plain {call_p:.4f} ms; "
              f"planes {bytes_read(b)} B read "
              f"({bytes_read(b) / ms_k / 1e9:.3f} TB/s); bound "
              f"{bound:.4f} ms ({nnz} entries); max|k-p| {err:.3e}",
              flush=True)
        if phase and (st["best"] is None or nnz > st["best"][0]):
            st["best"] = (nnz, ms_k, ms_p, tag, b.k, b.n_groups, bound,
                          phase)

    def check_bin_dd(tag, b, xh, xl, y0h, y0l, phase):
        """A dd bin through its kernel, storing and dd-adding onto (y0h,
        y0l), against its plain dd version; compared fp64-combined."""
        kernel, plain = dd_wrappers[b.layout], dd_plains[b.layout]
        want = plain(b, xh, xl)
        rows = b.group_ids.long()
        base = (y0h.view(-1, 8, 128)[rows], y0l.view(-1, 8, 128)[rows])
        err = 0.0
        for accumulate in (False, True):
            yh, yl = y0h.clone(), y0l.clone()
            kernel(b, xh, xl, yh, yl, accumulate=accumulate)
            got = combine_f64(yh.view(-1, 8, 128)[rows],
                              yl.view(-1, 8, 128)[rows])
            exp = combine_f64(*(dd_add_dd(*base, *want) if accumulate
                                else want))
            e = (got - exp).abs().max().item()
            if not e <= DD_TOL * exp.abs().max().item():
                fail(f"{tag} ({b.layout} dd, accumulate={accumulate}): "
                     f"max|k-p| = {e}")
            err = max(err, e)
        st = stats_dd[b.layout]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        yh, yl = y0h.clone(), y0l.clone()
        ms_k = device_time_fn(kernel, b, xh, xl, yh, yl, device=dev) * 1e3
        ms_p = device_time_fn(plain, b, xh, xl, device=dev,
                              reps=PLAIN_DD_REPS) * 1e3
        call_k = time_fn(kernel, b, xh, xl, yh, yl, device=dev) * 1e3
        call_p = time_fn(plain, b, xh, xl, device=dev) * 1e3
        bound, nnz = bound_ms(b, (xh, xl))
        print(f"{tag} {b.layout} dd k={b.k} groups={b.n_groups} "
              f"span={b.span} ja={str(b.ja.dtype)[6:]}"
              f"{' add_into' if b.add_into else ''}: device kernel "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms; call kernel "
              f"{call_k:.4f} ms, plain {call_p:.4f} ms; "
              f"planes {bytes_read(b)} B read "
              f"({bytes_read(b) / ms_k / 1e9:.3f} TB/s); bound "
              f"{bound:.4f} ms ({nnz} entries); max|k-p| {err:.3e}",
              flush=True)
        if phase and (st["best"] is None or nnz > st["best"][0]):
            st["best"] = (nnz, ms_k, ms_p, tag, b.k, b.n_groups, bound,
                          phase)

    for name, sell, _, x, csr in runs:
        uploads = [(dt, False) for dt in (torch.float32, torch.bfloat16)]
        if name in SB_I16_PHASES:
            uploads += [(dt, True) for dt in (torch.float32, torch.bfloat16)]
        for dtype, i16 in uploads:
            d = S.device_put_sell(sell, dtype, device=dev, sb_i16=i16)
            if i16 and not any(b.ja.dtype == torch.int16 for b in d.bins):
                fail(f"{name}: sb_i16 packed no bin")
            xt = S.device_put_x(x, sell.ncols, device=dev)
            y_k = S.sell_spmv(d, xt)
            y_p = S.sell_spmv_plain(d, xt)
            atol = ATOL_REL * float(y_p.abs().max())
            if not torch.allclose(y_k, y_p, rtol=RTOL, atol=atol):
                fail(f"{name} {dtype} i16={i16}: kernels disagree with the "
                     f"plain versions, max|k-p| = "
                     f"{(y_k - y_p).abs().max().item()}")
            sec_k = time_fn(S.sell_spmv, d, xt, device=dev)
            sec_p = time_fn(S.sell_spmv_plain, d, xt, device=dev)
            dev_k = device_time_fn(S.sell_spmv, d, xt, device=dev)
            nb = device_bytes(d)
            nread = sum(bytes_read(b) for b in d.bins)
            lib = (lib_note(name, csr, x, torch.float32)
                   if dtype == torch.float32 and not i16 else "")
            need = csr_bound_ms(csr, torch.tensor([], dtype=dtype)
                                .element_size(), 1)
            tag = f"[{name}] {str(dtype)[6:]}{' i16' if i16 else ''}"
            print(f"{tag} SpMV per call: kernels "
                  f"{calculate_flops(sell.nnz, sec_k) / 1e9:.3f} GFLOPS "
                  f"({sec_k * 1e3:.4f} ms), plain "
                  f"{calculate_flops(sell.nnz, sec_p) / 1e9:.3f} GFLOPS "
                  f"({sec_p * 1e3:.4f} ms); device time back to back "
                  f"{dev_k * 1e3:.4f} ms = "
                  f"{calculate_flops(sell.nnz, dev_k) / 1e9:.3f} GFLOPS; "
                  f"device bytes {nb} ({nb / dev_k / 1e12:.3f} TB/s), "
                  f"read {nread} ({nread / dev_k / 1e12:.3f} TB/s); matrix "
                  f"bound {need:.4f} ms; max|k-p| "
                  f"{(y_k - y_p).abs().max().item():.3e}{lib}", flush=True)
            y0 = torch.randn(d.num_groups * 1024, device=dev)
            for i, b in enumerate(d.bins):
                check_bin(f"{tag} bin {i}", b, xt, y0,
                          name if dtype == torch.float32 and not i16 else None)
            del d, xt, y_k, y_p, y0
            torch.cuda.empty_cache()

    for name, _, sell, x, csr in runs:
        if sell is None:
            continue
        for i16 in (False, True) if name in SB_I16_PHASES else (False,):
            d = D.device_put_sell_dd(sell, device=dev, sb_i16=i16)
            if i16 and not any(b.ja.dtype == torch.int16 for b in d.bins):
                fail(f"{name}: sb_i16 packed no dd bin")
            xh, xl = D.device_put_x_dd(x, sell.ncols, device=dev)
            y_k = combine_f64(*D.sell_spmv_dd(d, xh, xl))
            y_p = combine_f64(*D.sell_spmv_dd_plain(d, xh, xl))
            e = (y_k - y_p).abs().max().item()
            if not e <= DD_TOL * y_p.abs().max().item():
                fail(f"{name} dd i16={i16}: kernels disagree with the plain "
                     f"versions, max|k-p| = {e}")
            sec_k = time_fn(D.sell_spmv_dd, d, xh, xl, device=dev)
            sec_p = time_fn(D.sell_spmv_dd_plain, d, xh, xl, device=dev)
            dev_k = device_time_fn(D.sell_spmv_dd, d, xh, xl, device=dev)
            nb = device_bytes(d)
            nread = sum(bytes_read(b) for b in d.bins)
            lib = "" if i16 else lib_note(name, csr, x, torch.float64)
            need = csr_bound_ms(csr, 8, 2)
            tag = f"[{name}] dd{' i16' if i16 else ''}"
            print(f"{tag} SpMV per call: kernels "
                  f"{calculate_flops(sell.nnz, sec_k) / 1e9:.3f} GFLOPS "
                  f"({sec_k * 1e3:.4f} ms), plain "
                  f"{calculate_flops(sell.nnz, sec_p) / 1e9:.3f} GFLOPS "
                  f"({sec_p * 1e3:.4f} ms); device time back to back "
                  f"{dev_k * 1e3:.4f} ms = "
                  f"{calculate_flops(sell.nnz, dev_k) / 1e9:.3f} GFLOPS; "
                  f"device bytes {nb} ({nb / dev_k / 1e12:.3f} TB/s), "
                  f"read {nread} ({nread / dev_k / 1e12:.3f} TB/s); matrix "
                  f"bound {need:.4f} ms; max|k-p| {e:.3e}{lib}", flush=True)
            y0h = torch.randn(d.num_groups * 1024, device=dev)
            y0l = y0h * 2.0**-30
            for i, b in enumerate(d.bins):
                check_bin_dd(f"{tag} bin {i}", b, xh, xl, y0h, y0l,
                             None if i16 else name)
            del d, xh, xl, y_k, y_p, y0h, y0l
            torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        dps = S.device_put_sell(psell, dtype, device=dev)
        xd = torch.from_numpy(x32).to(dev)
        y_k = S.panel_sell_spmv(dps, xd)
        y_p = S.panel_sell_spmv_plain(dps, xd)
        if not torch.allclose(y_k, y_p, rtol=RTOL,
                              atol=ATOL_REL * float(y_p.abs().max())):
            fail(f"panels {dtype}: kernels disagree with the plain versions")
        for p, dsell in enumerate(dps.panels):
            c0, c1 = dps.bounds[p], dps.bounds[p + 1]
            xt = S.pack_x_table(xd[c0:c1], c1 - c0)
            y0 = torch.randn(dps.num_groups * 1024, device=dev)
            for i, b in enumerate(dsell.bins):
                check_bin(f"[panels] {str(dtype)[6:]} panel {p} bin {i}", b,
                          xt, y0, None)

    dps = D.device_put_sell_dd(psell, device=dev)
    xh, xl = (torch.from_numpy(h).to(dev)
              for h in split_f64(x32.astype(np.float64)))
    y_k = combine_f64(*D.panel_sell_spmv_dd(dps, xh, xl))
    y_p = combine_f64(*D.panel_sell_spmv_dd_plain(dps, xh, xl))
    if not (y_k - y_p).abs().max().item() <= DD_TOL * y_p.abs().max().item():
        fail("panels dd: kernels disagree with the plain versions")
    for p, dsell in enumerate(dps.panels):
        c0, c1 = dps.bounds[p], dps.bounds[p + 1]
        tabs = (S.pack_x_table(xh[c0:c1], c1 - c0),
                S.pack_x_table(xl[c0:c1], c1 - c0))
        y0h = torch.randn(dps.num_groups * 1024, device=dev)
        for i, b in enumerate(dsell.bins):
            check_bin_dd(f"[panels] dd panel {p} bin {i}", b, *tabs, y0h,
                         y0h * 2.0**-30, None)

    # ---- the PR kernels on every webbase_pr panel, and the whole SpMV ----
    def pr_bound_ms(p, vals, tables):
        """The least time of a PR problem's function: its real entries, the
        distinct x entries they read and its y rows."""
        real = vals[0] != 0
        cols = p.row_slab.long()[:, None] * 128 + (p.md & 127).long()
        return need_ms(int(real.sum()), 4 * len(vals),
                       int(torch.unique(cols[real]).numel()), p.nrows, tables)

    pr_host, x, csr = web
    pr_stats = {}
    xt = S.device_put_x(x, csr.ncols, device=dev)
    xh, xl = D.device_put_x_dd(x, csr.ncols, device=dev)
    for kind in ("pr", "pr_dd"):
        dd = kind == "pr_dd"
        dpr = (PRD.device_put_pr_dd(pr_host, device=dev) if dd
               else PR.device_put_pr(pr_host, device=dev))
        xs = (xh, xl) if dd else (xt,)
        kernel = pr_wrappers[kind]
        plain = PRD.pr_problem_plain_dd if dd else PR.pr_problem_plain
        for i, p in enumerate(dpr.panels):
            got, want = kernel(p, *xs), plain(p, *xs)
            if dd:
                got, want = combine_f64(*got), combine_f64(*want)
                err = (got - want).abs().max().item()
                ok = err <= DD_TOL * want.abs().max().item()
            else:
                err = (got - want).abs().max().item()
                ok = torch.allclose(got, want, rtol=RTOL,
                                    atol=ATOL_REL * float(want.abs().max()))
            if not ok:
                fail(f"[webbase_pr] {kind} panel {i}: the kernel disagrees "
                     f"with its plain version, max|k-p| = {err}")
            ms_k = device_time_fn(kernel, p, *xs, device=dev) * 1e3
            ms_p = device_time_fn(plain, p, *xs, device=dev,
                                  reps=PLAIN_PR_DD_REPS if dd
                                  else PLAIN_PR_REPS) * 1e3
            call_k = time_fn(kernel, p, *xs, device=dev) * 1e3
            vals = (p.val_h, p.val_l) if dd else (p.val,)
            planes = (nbytes(*vals, p.md, p.route, p.row_slab, p.bin_table,
                             *xs) + p.y_rows * 128 * 4 * len(xs))
            bound = pr_bound_ms(p, vals, len(xs))
            if i == 0:  # the JSON line's: the first and larger panel
                pr_stats[kind] = (ms_k, ms_p, err, bound)
            print(f"[webbase_pr] {kind} panel {i} ({p.n_rows} Beneš rows, "
                  f"{p.nnz} nnz, bins {p.bins}): device kernel {ms_k:.4f} "
                  f"ms, plain {ms_p:.4f} ms; call kernel {call_k:.4f} ms; "
                  f"planes, x tables and y {planes} B "
                  f"({planes / ms_k / 1e9:.3f} TB/s); bound {bound:.4f} ms; "
                  f"max|k-p| {err:.3e}", flush=True)
        spmv = PRD.pr_spmv_dd if dd else PR.pr_spmv
        dev_spmv = device_time_fn(spmv, dpr, *xs, device=dev) * 1e3
        lib = lib_note("webbase_pr", csr, x,
                       torch.float64 if dd else torch.float32)
        need = csr_bound_ms(csr, 8 if dd else 4, len(xs))
        print(f"[webbase_pr] {kind} SpMV of both panels device time "
              f"{dev_spmv:.4f} ms, matrix bound {need:.4f} ms{lib}",
              flush=True)
        del dpr
        torch.cuda.empty_cache()

    # ---- road_scattered's split: its far problem (K=1) through the PR
    # kernels, and the composite's device time ----
    sm, x, csr = road
    xt = S.device_put_x(x, csr.ncols, device=dev)
    xh, xl = D.device_put_x_dd(x, csr.ncols, device=dev)
    for dd in (False, True):
        ds = (SPL.device_put_split_dd(sm, device=dev) if dd
              else SPL.device_put_split(sm, device=dev))
        xs = (xh, xl) if dd else (xt,)
        kernel = PRD.pr_problem_dd if dd else PR.pr_problem
        plain = PRD.pr_problem_plain_dd if dd else PR.pr_problem_plain
        got, want = kernel(ds.far, *xs), plain(ds.far, *xs)
        spmv = SPL.split_spmv_dd if dd else SPL.split_spmv
        y_k = spmv(ds, *xs)
        y_p = (SPL.split_spmv_dd_plain if dd else SPL.split_spmv_plain)(
            ds, *xs)
        if dd:
            got, want = combine_f64(*got), combine_f64(*want)
            y_k, y_p = combine_f64(*y_k), combine_f64(*y_p)
            ok = all((a - b).abs().max().item()
                     <= DD_TOL * b.abs().max().item()
                     for a, b in ((got, want), (y_k, y_p)))
        else:
            ok = all(torch.allclose(a, b, rtol=RTOL,
                                    atol=ATOL_REL * float(b.abs().max()))
                     for a, b in ((got, want), (y_k, y_p)))
        if not ok:
            fail(f"[road_scattered] split{' dd' if dd else ''}: the kernels "
                 "disagree with the plain versions")
        ms_far = device_time_fn(kernel, ds.far, *xs, device=dev) * 1e3
        ms_split = device_time_fn(spmv, ds, *xs, device=dev) * 1e3
        print(f"[road_scattered] split{' dd' if dd else ''}: far PR problem "
              f"({ds.far.n_rows} Beneš rows, bins {ds.far.bins}) device "
              f"{ms_far:.4f} ms; split SpMV device time {ms_split:.4f} ms; "
              f"max|k-p| {(y_k - y_p).abs().max().item():.3e}", flush=True)
        del ds
    torch.cuda.empty_cache()

    summary = []
    for table, kernels, run_stats, launched, lib_dtype in (
            ("", KERNELS, stats, launches, torch.float32),
            (" dd", DD_KERNELS, stats_dd, launches_dd, torch.float64)):
        for lay, (kname, source, replaces) in kernels.items():
            nnz, ms_k, ms_p, tag, k, ng, bound, phase = \
                run_stats[lay]["best"]
            print(f"{kname}: device times at its largest main-path bin "
                  f"({tag}, k={k}, {ng} groups, {nnz} entries,"
                  f"{table or ' f32'} values)")
            summary.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched[lay],
                "max_abs_err": run_stats[lay]["max_abs_err"], "ms": ms_k,
                "plain_ms": ms_p, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library[phase, lib_dtype][0]})
    for kind, (kname, source, replaces) in PR_KERNELS.items():
        ms_k, ms_p, err, bound = pr_stats[kind]
        summary.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_pr[kind],
            "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library["webbase_pr", torch.float64
                                  if kind == "pr_dd" else torch.float32][0]})
    print(f"smoke ran {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
