#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's SELL SpMV main path on one GPU,
f32, bf16 and double-double (fp64-class).

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``csrc/``, then drives the main path
(generate or read a matrix -> CSR -> SELL "auto" -> upload -> SpMV, validated
against the fp64 oracle) through ``run_matrix`` on seven phases, each of
which must convert to exactly the bin layouts named beside it:

* entry:              banded(8192, 24, 512): k-major;
* mixed:              fem_3d(20, 20, 20, dof=3): k-major and wl in one matrix;
* mtx:                a banded matrix written as Matrix Market and read back;
* headline:           fem_3d(60, 60, 60, dof=3), bench.py's fem3d_cube: wl;
* banded_adversarial: banded(250_000, 60, 2500), bench.py's: sb-major;
* road_scattered:     road_network(1_200_000), bench.py's road: sb-list;
* scattered_uniform:  random_general(200_000, 200_000, 2.5e-4), the suite's
                      random_uniform: sg (static and dynamic window tables)
                      plus accumulating (add_into) k-major far bins;

and then a panel phase: fem_3d(10, 10, 10, dof=3) split into 1024-column
panels (k-major and wl bins) through ``panel_sell_spmv``, every bin
accumulating.

Each phase runs f32 and bf16 values and must show no significant difference
from the fp64 oracle (bf16: the oracle of the bf16-quantized matrix). Each
phase, the panel phase included, also runs the double-double stage
(``sell_dd``; scattered_uniform's slot-packed sg bins are rebuilt in rows
mode for it): no significant difference and a norm-scaled error
``max|y - y_ref| / max|y_ref|`` below 1e-12. The kernels' launch counters
are reset before the phases and read after them; every kernel and every dd
kernel, and the k-major kernel of both precisions in accumulate mode, must
have been launched.

Then every bin of every phase, banded_adversarial and road_scattered also
with int16 sb index planes, is run through its kernel, storing and
accumulating, and through its plain PyTorch version on the card; they must
agree within rtol=1e-5, atol=1e-5*max|y| (f32 sums in another order), or
for the dd kernels within 1e-12*max|y| on the fp64-combined result (dd sums
in another order). Both are timed twice: device time (CUDA events around
calls queued back to back behind a spin kernel, per call) and call time
(CUDA events around each call, host included). The JSON summary's ``ms``
and ``plain_ms`` are device times, at each kernel's largest main-path bin
with f32 (or dd) values and int32 index planes.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before them;
so does a machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
RTOL = 1e-5
ATOL_REL = 1e-5  # atol = ATOL_REL * max|y_plain|
DD_TOL = 1e-12   # dd: kernel vs plain, times max|y|; norm-scaled error
# a plain dd call queues 80-200 small kernels; device_time_fn queues its reps
# behind one spin, and more than the stream's launch queue holds would block
# the host until the spin ends
PLAIN_DD_REPS = 3
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
SB_I16_PHASES = ("banded_adversarial", "road_scattered")


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


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sparsematrixvectormultiplication_tpu_torch import (
        COOMatrix, CSRMatrix, PanelSellMatrix, run_matrix)
    from sparsematrixvectormultiplication_tpu_torch.bench.harness import (
        quantize_bf16)
    from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
        write_matrix_market)
    from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
        banded, fem_3d, random_general, road_network)
    from sparsematrixvectormultiplication_tpu_torch.ops import _build
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
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

    # name, matrix, the layouts its conversion must hold
    phases = [
        ("entry", lambda: banded(8192, 24, 512, seed=0), {"k-major"}),
        ("mixed", lambda: fem_3d(20, 20, 20, dof=3, seed=1),
         {"k-major", "wl"}),
        ("mtx", lambda: mtx_roundtrip(lambda: banded(6000, 16, 400, seed=2),
                                      COOMatrix.from_mtx,
                                      write_matrix_market), {"k-major"}),
        ("headline", lambda: fem_3d(60, 60, 60, dof=3, seed=1), {"wl"}),
        ("banded_adversarial", lambda: banded(250_000, 60, 2500, seed=1),
         {"sb-major"}),
        ("road_scattered", lambda: road_network(1_200_000, seed=1),
         {"sb-list"}),
        ("scattered_uniform",
         lambda: random_general(200_000, 200_000, 2.5e-4, seed=8),
         {"sg", "k-major"}),
    ]
    wrappers = S._KERNEL
    plains = S._PLAIN
    dd_wrappers = D._KERNEL_DD
    dd_plains = D._PLAIN_DD

    def counts(ws=wrappers):
        return {lay: w.launches for lay, w in ws.items()}

    # ---- the main path; the launch counts are read from this run only ----
    for w in (*wrappers.values(), *dd_wrappers.values()):
        w.launches = 0
        w.accumulating = 0
    runs = []
    for name, make, layouts in phases:
        t0 = time.perf_counter()
        coo = make()
        x = np.random.default_rng(SEED).standard_normal(coo.ncols)
        before, before_dd = counts(), counts(dd_wrappers)
        res = run_matrix(name, coo, x=x, device=dev,
                         log=lambda m: print(m, flush=True))
        bins = res.sell.bins
        got = {b.layout for b in bins}
        if got != layouts:
            fail(f"{name}: the conversion gave layouts {sorted(got)}, "
                 f"the phase exists to run {sorted(layouts)}")
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
        for stage in ("sell", "sell_bf16", "sell_dd"):
            sig = res.stages[stage].diff.significant_diffs
            if sig:
                fail(f"{name} {stage}: {sig} significant diffs vs the oracle")
        dd_err = res.stages["sell_dd"].norm_err
        if not dd_err < DD_TOL:
            fail(f"{name} sell_dd: norm-scaled error {dd_err:.3e} >= {DD_TOL}")
        now, now_dd = counts(), counts(dd_wrappers)
        for lay in layouts:
            if now[lay] <= before[lay]:
                fail(f"{name}: the {lay} kernel was not launched")
        for lay in got_dd:
            if now_dd[lay] <= before_dd[lay]:
                fail(f"{name}: the {lay} dd kernel was not launched")
        shapes = [[(b.layout, b.k, b.n_groups, b.span) for b in s.bins]
                  for s in (res.sell, res.sell_dd)]
        print(f"[{name}] {coo.nrows} rows, {coo.nnz} nnz, bins {shapes[0]}, "
              f"padding {res.sell.padding_ratio:.3f}; sell_dd bins "
              f"{shapes[1]}, {res.stages['sell_dd'].seconds * 1e3:.4f} ms "
              "per call, "
              f"norm-scaled error {dd_err:.3e}; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        runs.append((name, res.sell, res.sell_dd, x))

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

    def check_bin(tag, b, xt, y0, measure):
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
        print(f"{tag} {b.layout} k={b.k} groups={b.n_groups} span={b.span} "
              f"ja={str(b.ja.dtype)[6:]}{' add_into' if b.add_into else ''}: "
              f"device kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms; call "
              f"kernel {call_k:.4f} ms, plain {call_p:.4f} ms; "
              f"{bytes_read(b) / ms_k / 1e9:.3f} TB/s read; max|k-p| "
              f"{err:.3e}", flush=True)
        slots = b.n_groups * b.k * 1024
        if measure and (st["best"] is None or slots > st["best"][0]):
            st["best"] = (slots, ms_k, ms_p, tag, b.k, b.n_groups)

    def check_bin_dd(tag, b, xh, xl, y0h, y0l, measure):
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
        print(f"{tag} {b.layout} dd k={b.k} groups={b.n_groups} "
              f"span={b.span} ja={str(b.ja.dtype)[6:]}"
              f"{' add_into' if b.add_into else ''}: device kernel "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms; call kernel "
              f"{call_k:.4f} ms, plain {call_p:.4f} ms; "
              f"{bytes_read(b) / ms_k / 1e9:.3f} TB/s read; max|k-p| "
              f"{err:.3e}", flush=True)
        slots = b.n_groups * b.k * 1024
        if measure and (st["best"] is None or slots > st["best"][0]):
            st["best"] = (slots, ms_k, ms_p, tag, b.k, b.n_groups)

    for name, sell, _, x in runs:
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
            nbytes = device_bytes(d)
            nread = sum(bytes_read(b) for b in d.bins)
            tag = f"[{name}] {str(dtype)[6:]}{' i16' if i16 else ''}"
            print(f"{tag} SpMV per call: kernels "
                  f"{calculate_flops(sell.nnz, sec_k) / 1e9:.3f} GFLOPS "
                  f"({sec_k * 1e3:.4f} ms), plain "
                  f"{calculate_flops(sell.nnz, sec_p) / 1e9:.3f} GFLOPS "
                  f"({sec_p * 1e3:.4f} ms); device time back to back "
                  f"{dev_k * 1e3:.4f} ms = "
                  f"{calculate_flops(sell.nnz, dev_k) / 1e9:.3f} GFLOPS; "
                  f"device bytes {nbytes} ({nbytes / dev_k / 1e12:.3f} TB/s), "
                  f"read {nread} ({nread / dev_k / 1e12:.3f} TB/s); max|k-p| "
                  f"{(y_k - y_p).abs().max().item():.3e}", flush=True)
            y0 = torch.randn(d.num_groups * 1024, device=dev)
            for i, b in enumerate(d.bins):
                check_bin(f"{tag} bin {i}", b, xt, y0,
                          dtype == torch.float32 and not i16)
            del d, xt, y_k, y_p, y0
            torch.cuda.empty_cache()

    for name, _, sell, x in runs:
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
            nbytes = device_bytes(d)
            nread = sum(bytes_read(b) for b in d.bins)
            tag = f"[{name}] dd{' i16' if i16 else ''}"
            print(f"{tag} SpMV per call: kernels "
                  f"{calculate_flops(sell.nnz, sec_k) / 1e9:.3f} GFLOPS "
                  f"({sec_k * 1e3:.4f} ms), plain "
                  f"{calculate_flops(sell.nnz, sec_p) / 1e9:.3f} GFLOPS "
                  f"({sec_p * 1e3:.4f} ms); device time back to back "
                  f"{dev_k * 1e3:.4f} ms = "
                  f"{calculate_flops(sell.nnz, dev_k) / 1e9:.3f} GFLOPS; "
                  f"device bytes {nbytes} ({nbytes / dev_k / 1e12:.3f} TB/s), "
                  f"read {nread} ({nread / dev_k / 1e12:.3f} TB/s); max|k-p| "
                  f"{e:.3e}", flush=True)
            y0h = torch.randn(d.num_groups * 1024, device=dev)
            y0l = y0h * 2.0**-30
            for i, b in enumerate(d.bins):
                check_bin_dd(f"{tag} bin {i}", b, xh, xl, y0h, y0l, not i16)
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
                          xt, y0, False)

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
                         y0h * 2.0**-30, False)

    summary = []
    for lay, (kname, source, replaces) in KERNELS.items():
        slots, ms_k, ms_p, tag, k, ng = stats[lay]["best"]
        print(f"{kname}: device times at its largest main-path bin "
              f"({tag}, k={k}, {ng} groups, f32 values)")
        summary.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[lay],
                        "max_abs_err": stats[lay]["max_abs_err"],
                        "ms": ms_k, "plain_ms": ms_p})
    for lay, (kname, source, replaces) in DD_KERNELS.items():
        slots, ms_k, ms_p, tag, k, ng = stats_dd[lay]["best"]
        print(f"{kname}: device times at its largest main-path bin "
              f"({tag}, k={k}, {ng} groups, dd values)")
        summary.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches_dd[lay],
                        "max_abs_err": stats_dd[lay]["max_abs_err"],
                        "ms": ms_k, "plain_ms": ms_p})
    print(f"smoke ran {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
