#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main paths on one GPU: the card's
bandwidth and kernel-variant probes, SELL SpMV (f32, bf16 and
double-double), the benchmark harness's HLL, CSR, ELL and SELL-sigma stages
and RCM reordering, the PR layout (f32, bf16 values and double-double) and
the locality split, ``auto_device_op``, and multi-RHS SpMM (SELL k-major
and wl, 128x128 BSR).

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``csrc/`` and the PR router, BSR blocker,
CSR converter and Matrix Market parser from ``native/``, then runs the
bandwidth phase: ``bench.bw_probe.run_probes`` at full size (512 MB
buffers, kernelsim at 240 groups of K=64), which must launch each of the
four probe kernels (``bw_read``, ``bw_copy``, ``bw_read_async``,
``bw_kernelsim``). Then the kernel-variant phase:
``bench.kernel_probe.run_kernel_probes`` runs the five TPU kernel probes'
sweeps (probes/kernel_probe{,2,3,4,5}.py) variant for variant at full size
(16,777,216 entries a plane, 2^21 rows a probe-4 stream), each variant's
kernel held bit for bit against its plain version and against the probe's
checksum on small integers; each of ``kp_decode``, ``kp_fused`` and
``kp_colsum`` must launch (the counts include each variant's checked call).
Then it drives the main path (generate or read a matrix
-> CSR -> layout -> upload -> SpMV or SpMM, validated against the fp64
oracle) through ``run_matrix`` on ten phases, each of which must convert to
exactly the SELL bin layouts named beside it, with the cache flushed before
each stage and each stage timed as the best of 3 device-time rounds:

* entry:              banded(8192, 24, 512): k-major; also ``sell_spmm``
                      (R=16, heavy-row segments reduced by index_add_);
* mixed:              fem_3d(20, 20, 20, dof=3): k-major and wl in one
                      matrix; also ``sell_spmm``;
* mtx:                a banded matrix written as Matrix Market and read back
                      (the native parser reads its body);
* headline:           fem_3d(60, 60, 60, dof=3), bench.py's fem3d_cube: wl;
                      also ``serial_hll``, ``csr``, ``ell``, ``hll`` and
                      ``sell_sigma``; then ``sell_spmm`` on its own wl SELL
                      at R=8 and R=16 (the wl SpMM kernel; every bin must be
                      wl);
* banded_adversarial: banded(250_000, 60, 2500), bench.py's: sb-major; also
                      the five stages above, ``sell_spmm`` (R=16 on a SELL
                      forced to k-major) and ``bsr_spmm``, which must be
                      skipped: its 128x128 blocks exceed the 2 GiB budget;
                      run with ``device_validate``: every timed rep of a
                      kernel stage must equal its first;
* scrambled_band_rcm: banded(200_000, 16, 64) behind a random symmetric
                      permutation, run with ``reorder="rcm"``: RCM must
                      bring its p98 bandwidth down at least 100x, and the
                      reordered matrix converts to k-major (``csr``,
                      ``sell``, ``hll``, ``sell_sigma``);
* band64_250k:        banded(250_000, 64, 64, seed=11), the BSR case of
                      probes/bsr_spmm_tpu.py: ``sell`` (forced to k-major:
                      the main path's k-major bin that streams from HBM),
                      ``sell_spmm`` and ``bsr_spmm`` (B=128); then ``bsr_spmm`` on its
                      blocks in f32 and bf16, at B=128 and B=512, by both
                      routes, each validated against the fp64 oracle (bf16:
                      the oracle of the bf16-rounded blocks and X, at abs
                      1e-2 / rel 0.02);
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
                      stages on 2 PR panels of 16,384 Beneš rows; then
                      ``pr`` again at ``dtype="bfloat16"`` (bf16 values,
                      the ``pr_spmv_bf16`` kernel);

and then a panel phase: fem_3d(10, 10, 10, dof=3) split into 1024-column
panels (k-major and wl bins) through ``panel_sell_spmv`` and ``sell_spmm``
(R=8), every bin accumulating; and ``auto_device_op`` on the mixed and
road_scattered matrices and on power_law(200_000, 3), which must pick
"sell", "split" and "pr" and whose ``matvec`` must launch the kernels of
what it picked.

Every stage and every ``matvec`` must show no significant difference from
the fp64 oracle (bf16: the oracle of the bf16-quantized matrix; SpMM: on 4
sampled columns); the dd stages also a norm-scaled error ``max|y - y_ref| /
max|y_ref|`` below 1e-12. The SELL phases run f32, bf16 and dd
(``sell_dd``; scattered_uniform's slot-packed sg bins are rebuilt in rows
mode for it), webbase_pr and band64_250k only f32. The kernels' launch counters are reset
before the phases and read after them and the panel phase, before
``auto_device_op``; every kernel and every dd kernel, the k-major kernel of
both precisions in accumulate mode, the PR kernel with bf16 values, every
SpMM kernel (both BSR routes among them) and both SELL SpMM kernels in
accumulate mode must have been launched. The probe kernels' counters are
reset before the bandwidth phase and read after it. Each phase prints its
host set-up: the CSR conversion (the native converter from 2,000,000
entries), the sum of its conversions and the phase's wall time.

Then every bin of every phase, banded_adversarial and road_scattered also
with int16 sb index planes, is run through its kernel, storing and
accumulating, and through its plain PyTorch version on the card; they must
agree within rtol=1e-5, atol=1e-5*max|y| (f32 sums in another order), or
for the dd kernels within 1e-12*max|y| on the fp64-combined result (dd sums
in another order). So are webbase_pr's PR panels through the PR and
PR-dd kernels, road_scattered's split (its K=1 far problem through the
PR kernels, and the composite), every bin of the SELL SpMM runs (the
sell_spmm SELLs at R=16, the headline's wl bins at R=8 and 16; f32, and
bf16 values on the headline and banded_adversarial, at the same
tolerance: the plain versions widen bf16 exactly as the kernels do, so
only the order of the f32 sums differs), and band64_250k's blocks through
both BSR routes (f32 and bf16, B=128 and 512, the same tolerance for the
same reason). Column j of each SELL SpMM result must equal the SpMV kernel
on X[:, j] bit for bit on the headline and banded_adversarial. Kernel and
plain version are each timed twice: device time (CUDA events around calls
queued back to back behind a spin kernel, per call) and call time (CUDA
events around each call, host included). Beside each phase's SpMV, the
device time of cuSPARSE's CSR SpMV (``torch.sparse_csr_tensor @ x``) on the
phase's whole matrix, f32 values beside the f32/bf16 kernels and fp64
beside the dd kernels, is printed, and beside each SpMM kernel cuSPARSE's
CSR SpMM (``torch.sparse_csr_tensor @ X``, f32, the same X); they are
yardsticks only, which no module of the port calls.

Each probe kernel is held against its plain version at the bandwidth
phase's sizes, bit for bit (the probe's data are small integers, so every
f32 sum is exact): the reads over the 512 MB f32 buffer, the int32, int16
and int8 planes and the two streams, the copy, every ``cp.async``
configuration, and kernelsim's variants; their JSON rows take the f32 read,
the copy, the ``cp.async`` configuration of 32-row chunks 2 stages deep and
kernelsim's span-4 run, with ``bound_ms`` their bytes (kernelsim: its
planes, its chunks' window indices, the distinct x entries it reads and
its y) over 3.35 TB/s and ``library_ms`` the same function as one PyTorch
call (``a.view(-1, 8, 128).sum(0)``, ``torch.add(buf, s, out=...)``; none
for kernelsim). webbase_pr's panels also run through ``pr_spmv_bf16``
against its plain version, at the f32 tolerance (the plain version widens
bf16 as the kernel does); its JSON row is panel 0, beside cuSPARSE f32 on
the bf16-rounded values (the same function), and the panel phase's
matrix gets its cuSPARSE times too.

The kernel-variant rows of the JSON summary are the phase's own records:
``kp_decode`` at probe 1's ``span4_i32``, ``kp_fused`` at probe 4's
``fused_gather_kb8192``, ``kp_colsum`` at probe 4's ``read1_kb8192``
(``library_ms``: ``a.sum(0)``), each ``bound_ms`` the variant's planes and
tables, the distinct x entries it reads and its output over 3.35 TB/s.

The JSON summary's ``ms`` and ``plain_ms`` are device times, at each
kernel's main-path bin with the most entries among those whose planes
exceed twice the L2 (so they stream from HBM and their time can be held
against the bound; the largest bin where none does; PR: webbase_pr's panel 0;
SELL SpMM at R=16; BSR: band64_250k at B=128) with f32 (or dd) values and
int32 index planes; ``bound_ms`` is the least time the card could take for
the function that bin computes: the larger of its bytes over 3.35 TB/s
(its real entries' values and 4 B columns, each distinct x entry (per x
table or right-hand side) they read and each y entry they write, moved
once) and its useful FLOP (2 per entry and right-hand side) over the 67
TFLOP/s f32 rate; ``bound_by`` says which. SpMV does ~2 FLOP per entry f32
and ~20 dd, so bytes bind; beside the BSR kernels the smoke prints band64's
kept 16x16 sub-tiles (those ``tile_mask`` marks nonzero, the ones the
kernels multiply), the FLOP they make and the dense-block FLOP (every
stored block multiplied whole). It also prints the upload seconds of the
PR problems' destination-order planes and of ``tile_mask``, and each PR
and BSR kernel's factor against cuSPARSE in the same call. Padding, index tables and the
layout's own planes are not counted; the bytes the layout's planes hold are
printed beside it. ``library_ms`` is the cuSPARSE time of the bin's phase.

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
# a plain SELL SpMM call on the headline's main bin at R=16 queues ~220
# kernels in 22 chunks of groups, a plain BSR call at B=512 ~70
PLAIN_SPMM_REPS = 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
F32_FLOP_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
SPMM_RHS = 16              # R of the SELL SpMM runs (the sell_spmm stage's)
HEADLINE_RHS = (8, 16)
BSR_RHS = (128, 512)       # B of the direct bsr_spmm calls
BSR_BF16_TOL = (1e-2, 0.02)  # abs, rel: probes/bsr_spmm_tpu.py:110
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
    "pr_bf16": ("pr_spmv_bf16", f"{PKG}/csrc/pr.cu",
                "sparsematrixvectormultiplication_tpu/ops/pallas_pr.py:150"),
    "pr_dd": ("pr_spmv_dd", f"{PKG}/csrc/pr.cu",
              "sparsematrixvectormultiplication_tpu/ops/pallas_pr_dd.py:114"),
}
TPU_SPMM = "sparsematrixvectormultiplication_tpu/ops"
SPMM_KERNELS = {
    # wrapper key: (name, source, TPU kernel replaced)
    "k-major": ("sell_k_major_spmm", f"{PKG}/csrc/sell_spmm.cu",
                f"{TPU_SPMM}/pallas_sell_spmm.py:85"),
    "wl": ("sell_wl_spmm", f"{PKG}/csrc/sell_spmm.cu",
           f"{TPU_SPMM}/pallas_sell_spmm.py:152"),
    "blockspec": ("bsr_spmm_blockspec", f"{PKG}/csrc/bsr.cu",
                  f"{TPU_SPMM}/pallas_bsr.py:102"),
    "dma": ("bsr_spmm_dma", f"{PKG}/csrc/bsr.cu",
            f"{TPU_SPMM}/pallas_bsr.py:124"),
}
PROBE = "probes/bw_probe.py"
BW_KERNELS = {
    # wrapper key: (name, TPU kernel replaced)
    "bw_read": ("bw_read", f"{PROBE}:78"),
    "bw_copy": ("bw_copy", f"{PROBE}:135"),
    "bw_read_async": ("bw_read_async", f"{PROBE}:155"),
    "bw_kernelsim": ("bw_kernelsim", f"{PROBE}:208"),
}
BW_JSON_ASYNC = (32, 2)  # chunk_rows, nbuf of bw_read_async's JSON row
KP_KERNELS = {
    # wrapper key: (the variant of its JSON row, TPU kernels replaced)
    "kp_decode": ("span4_i32", ", ".join(
        f"probes/kernel_probe{f}" for f in (
            ".py:96", "2.py:76", "3.py:76", "4.py:285", "5.py:70"))),
    "kp_fused": ("fused_gather_kb8192", "probes/kernel_probe3.py:76 "
                 "(k_fused), probes/kernel_probe4.py:154, "
                 "probes/kernel_probe4.py:209"),
    "kp_colsum": ("read1_kb8192", "probes/kernel_probe4.py:88, "
                  "probes/kernel_probe4.py:118"),
}
SB_I16_PHASES = ("banded_adversarial", "road_scattered")
# run_matrix's host and plain-PyTorch stages of the JAX harness, and the two
# SELL-kernel stages it adds (pallas_hll, pallas_sell_sigma)
HARNESS_STAGES = ("serial_hll", "csr", "ell", "hll", "sell_sigma")
SELL_STAGES = ("sell", "sell_bf16", "sell_dd")
# phase -> {stage: a word its skip reason must hold}
SKIPS = {"banded_adversarial": {"bsr_spmm": "budget"}}
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
    try:
        from sparsematrixvectormultiplication_tpu_torch import (
            COOMatrix, CSRMatrix, PanelPRMatrix, PanelSellMatrix, PRMatrix,
            auto_device_op, run_matrix)
    except ModuleNotFoundError as e:
        fail(f"{e}: run this script from the root of a checkout, beside "
             f"the {PKG} package")
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        bw_probe as BW)
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        kernel_probe as KP)
    from sparsematrixvectormultiplication_tpu_torch.bench.harness import (
        STAGES, BenchConfig, quantize_bf16)
    from sparsematrixvectormultiplication_tpu_torch.io.mmio import (
        write_matrix_market)
    from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
        banded, fem_3d, power_law, random_general, road_network,
        webbase_like)
    from sparsematrixvectormultiplication_tpu_torch.native import (
        build as native_build)
    from sparsematrixvectormultiplication_tpu_torch.ops import _build
    from sparsematrixvectormultiplication_tpu_torch.ops import bsr as BSR
    from sparsematrixvectormultiplication_tpu_torch.ops import pr as PR
    from sparsematrixvectormultiplication_tpu_torch.ops import pr_dd as PRD
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
    from sparsematrixvectormultiplication_tpu_torch.ops import split as SPL
    from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
        combine_f64, dd_add_dd, split_f64)
    from sparsematrixvectormultiplication_tpu_torch.utils.metrics import (
        calculate_flops)
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn, time_fn)
    from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
        difference_metrics, sampled_spmm_metrics)

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
    for stem, load in (("fastbsr", native_build.load_fast_bsr),
                       ("fastcsr", native_build.load_fast_csr),
                       ("fastmmio", native_build.load_fast_mmio)):
        t0 = time.perf_counter()
        load()
        print(f"{native_build._LIBS[stem][1]} built and loaded in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{native_build.library_path(stem).name}")

    # ---- the bandwidth phase: the probe's entry point at full size; the
    # probe kernels' launch counts are read from this run only ----
    t0 = time.perf_counter()
    for w in BW.KERNELS.values():
        w.launches = 0
    probes = {r["probe"]: r for r in BW.run_probes(
        dev, emit=lambda line: None, log=lambda m: print(m, flush=True))}
    launches_bw = {k: w.launches for k, w in BW.KERNELS.items()}
    idle = sorted(k for k, n in launches_bw.items() if n == 0)
    if idle:
        fail(f"bandwidth: the probe kernels {idle} were not launched")
    copy_rate = probes["bw_copy_f32"]["GBps"] * 1e9
    print(f"[bandwidth] {len(probes)} probes; launches {launches_bw}; copy "
          f"(read + write) {copy_rate / 1e12:.4f} TB/s = "
          f"{copy_rate / HBM_BYTES_PER_S:.1%} of the {HBM_BYTES_PER_S:.3g} "
          f"B/s spec: the %STREAM denominator; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the kernel-variant phase: the five TPU kernel probes' sweeps at
    # full size (16,777,216 entries a plane, 2^21 rows a probe-4 stream);
    # run_kernel_probes holds every variant's kernel against its plain
    # version bit for bit and against the probe's checksum, and raises
    # otherwise; the counts are read from this run only ----
    t0 = time.perf_counter()
    for w in KP.KERNELS.values():
        w.launches = 0
    kp_recs = {r["variant"]: r for r in KP.run_kernel_probes(
        dev, emit=lambda line: None, copy_rate=copy_rate,
        log=lambda m: print(f"[kernel_probe] {m}", flush=True))}
    launches_kp = {k: w.launches for k, w in KP.KERNELS.items()}
    idle = sorted(k for k, n in launches_kp.items() if n == 0)
    if idle:
        fail(f"kernel_probe: the kernels {idle} were not launched")
    print(f"[kernel_probe] {len(kp_recs)} variants, every kernel equal to "
          f"its plain version bit for bit; launches {launches_kp}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    def need_ms(nnz, value_bytes, n_x, n_y, tables):
        """The least time of an SpMV piece: ``nnz`` entries of
        ``value_bytes`` plus a 4 B column, ``n_x`` distinct x entries and
        ``n_y`` y rows per x table (``tables``: 2 for dd), over the HBM
        rate."""
        moved = nnz * (value_bytes + 4) + (n_x + n_y) * 4 * tables
        return moved / HBM_BYTES_PER_S * 1e3

    def spmm_need(nnz, value_bytes, n_x, n_y, rhs, x_bytes=4,
                  flop_rate=F32_FLOP_PER_S):
        """``(ms, bound_by)``, the least time of an SpMM piece: ``nnz``
        entries of ``value_bytes`` plus a 4 B column, ``n_x`` distinct x rows
        of ``rhs`` values of ``x_bytes`` and ``n_y`` f32 y rows of ``rhs``
        over the HBM rate, or its 2 FLOP per entry and right-hand side over
        ``flop_rate``, whichever is longer."""
        moved = nnz * (value_bytes + 4) + rhs * (n_x * x_bytes + n_y * 4)
        by_bytes = moved / HBM_BYTES_PER_S * 1e3
        by_ops = 2 * nnz * rhs / flop_rate * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (
            by_ops, "operations")

    used_cols = {}

    def csr_bound_ms(csr, value_bytes, tables):
        """The whole matrix's SpMV: every entry, every column it reads, every
        row of y."""
        if id(csr) not in used_cols:
            used_cols[id(csr)] = int(np.unique(csr.col_idx).size)
        return need_ms(csr.nnz, value_bytes, used_cols[id(csr)], csr.nrows,
                       tables)

    def scrambled_band():
        """A band behind a random symmetric permutation: RCM's case."""
        c = banded(200_000, 16, 64, seed=3)
        p = np.random.default_rng(3).permutation(c.nrows).astype(np.int32)
        return COOMatrix(c.nrows, c.ncols, p[c.row], p[c.col], c.val)

    # name, matrix, the SELL layouts its conversion must hold, stages (and
    # BenchConfig keywords)
    phases = [
        ("entry", lambda: banded(8192, 24, 512, seed=0), {"k-major"},
         (*SELL_STAGES, "sell_spmm")),
        ("mixed", lambda: fem_3d(20, 20, 20, dof=3, seed=1),
         {"k-major", "wl"}, (*SELL_STAGES, "sell_spmm")),
        ("mtx", lambda: mtx_roundtrip(lambda: banded(6000, 16, 400, seed=2),
                                      COOMatrix.from_mtx,
                                      write_matrix_market), {"k-major"},
         SELL_STAGES),
        ("headline", lambda: fem_3d(60, 60, 60, dof=3, seed=1), {"wl"},
         (*HARNESS_STAGES, *SELL_STAGES)),
        ("banded_adversarial", lambda: banded(250_000, 60, 2500, seed=1),
         {"sb-major"}, (*HARNESS_STAGES, *SELL_STAGES, "sell_spmm",
                        "bsr_spmm"), {"device_validate": True}),
        ("scrambled_band_rcm", scrambled_band, {"k-major"},
         ("csr", "sell", "hll", "sell_sigma"), {"reorder": "rcm"}),
        # sell forced to k-major: a 128 MB bin, the k-major kernel's JSON row
        ("band64_250k", lambda: banded(250_000, 64, 64, seed=11),
         {"k-major"}, ("sell", "sell_spmm", "bsr_spmm"),
         {"sell_layout": "k-major"}),
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

    spmm_wrappers = {"k-major": SM.k_major_spmm_bin, "wl": SM.wl_spmm_bin,
                     **BSR.ROUTES}

    def check_spmm(tag, csr, X, Y, tols=()):
        """SpMM result ``Y`` against the fp64 oracle on sampled columns."""
        dm = sampled_spmm_metrics(csr, X, Y, *tols)
        if dm.significant_diffs:
            fail(f"{tag}: {dm.significant_diffs} significant diffs vs the "
                 "oracle")
        return dm

    def headline_spmm(res):
        """``sell_spmm`` on the headline's own wl SELL at R = 8 and 16."""
        d = S.device_put_sell(res.sell, device=dev)
        if {b.layout for b in d.bins} != {"wl"} or res.sell.row_perm \
                is not None or res.sell.nrows != res.nrows:
            fail("headline: the SELL for the wl SpMM is not all wl bins in "
                 "the matrix's row order")
        for rhs in HEADLINE_RHS:
            X = np.random.default_rng(SEED).standard_normal(
                (res.ncols, rhs), dtype=np.float32)
            Y = SM.sell_spmm(d, SM.device_put_x_multi(X, res.ncols,
                                                      device=dev))
            dm = check_spmm(f"headline sell_spmm R={rhs}", res.csr, X,
                            Y.cpu().numpy().astype(np.float64))
            print(f"[headline] sell_spmm R={rhs} on the wl SELL: sig_diffs "
                  f"0, max_rel {dm.max_rel_err:.2e}", flush=True)
        return d

    def bsr_inputs(csr, dtype, rhs):
        """X (N, rhs) f32 from the seed, its padded table in ``dtype``, and
        the CSR and X of the oracle (bf16: the bf16-rounded operands)."""
        X = np.random.default_rng(SEED).standard_normal((csr.ncols, rhs),
                                                        dtype=np.float32)
        xp = BSR.pad_rhs(X, csr.ncols, dtype, device=dev)
        if dtype == torch.float32:
            return X, xp, csr, X
        q = type(csr)(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                      quantize_bf16(csr.values.astype(np.float32)))
        return X, xp, q, quantize_bf16(X)

    def band64_bsr(res):
        """``bsr_spmm`` on band64's blocks: f32 and bf16, B = 128 and 512,
        both routes, each against the fp64 oracle."""
        for dtype in (torch.float32, torch.bfloat16):
            d = BSR.device_put_bsr(res.bsr, dtype, device=dev)
            for rhs in BSR_RHS:
                _, xp, ocsr, oX = bsr_inputs(res.csr, dtype, rhs)
                tols = BSR_BF16_TOL if dtype == torch.bfloat16 else ()
                for route in BSR.ROUTES:
                    Y = BSR.bsr_spmm(d, xp, route=route)[:, :rhs]
                    dm = check_spmm(f"band64_250k bsr_spmm {dtype} B={rhs} "
                                    f"{route}", ocsr, oX,
                                    Y.cpu().numpy().astype(np.float64), tols)
                    print(f"[band64_250k] bsr_spmm {str(dtype)[6:]} B={rhs} "
                          f"{route}: sig_diffs 0, max_rel "
                          f"{dm.max_rel_err:.2e}", flush=True)
            del d
            torch.cuda.empty_cache()

    def webbase_bf16(name, coo, x):
        """``pr`` again at ``dtype="bfloat16"``: bf16 values through
        ``pr_spmv_bf16``, validated against the oracle of the bf16-rounded
        values and x."""
        before = PR.pr_problem.launches_bf16
        res = run_matrix(name, coo, BenchConfig(stages=("pr",),
                                                dtype="bfloat16"),
                         x=x, device=dev, log=lambda m: print(m, flush=True))
        check_pr(name, res)
        sig = res.stages["pr"].diff.significant_diffs
        if res.skipped or sig:
            fail(f"{name} pr bf16: skipped {res.skipped}, {sig} significant "
                 "diffs vs the oracle")
        if PR.pr_problem.launches_bf16 <= before:
            fail(f"{name}: the bf16 PR kernel was not launched")
        return (f"; pr bf16 {res.stages['pr'].seconds * 1e3:.4f} ms, "
                f"norm-scaled error {res.stages['pr'].norm_err:.2e}")

    def device_validated(name, res, ran):
        """``device_validate``'s check: every timed rep of a stage that runs
        the port's kernels equals the first (``csr``'s ``index_add_`` may
        order its atomic sums otherwise from rep to rep)."""
        notes = []
        for stage in ran:
            ex = res.stages[stage].extra
            if "device_val_max_diff" not in ex:
                continue  # a host stage
            diff = ex["device_val_max_diff"]
            if stage != "csr" and diff != 0.0:
                fail(f"{name} {stage}: a timed rep differs from the first "
                     f"by {diff}")
            notes.append(f"{stage} {diff:.1e} "
                         f"({ex['device_val_overhead_pct']:+.0f}%)")
        return "; device-validated reps, max diff (cost): " + ", ".join(notes)

    # ---- the main path; the launch counts are read from this run only ----
    for w in (*wrappers.values(), *dd_wrappers.values(),
              *pr_wrappers.values(), *spmm_wrappers.values()):
        w.launches = 0
        w.accumulating = 0
    PR.pr_problem.launches_bf16 = 0
    runs = []
    spmm_runs = []  # (phase, the k-major SELL of its sell_spmm stage, csr)
    phase_csr = {}
    web = road = band64 = headline = None
    for name, make, layouts, stages, *cfg_kw in phases:
        t0 = time.perf_counter()
        coo = make()
        x = np.random.default_rng(SEED).standard_normal(coo.ncols)
        before = (counts(), counts(dd_wrappers), counts(pr_wrappers),
                  counts(spmm_wrappers))
        res = run_matrix(name, coo, BenchConfig(stages=stages, **(
            cfg_kw[0] if cfg_kw else {})), x=x, device=dev,
                         log=lambda m: print(m, flush=True))
        if name == "scrambled_band_rcm":
            ro = res.format_stats["reorder"]
            if not ro["applied"] or ro["p98_gain"] < 100:
                fail(f"{name}: RCM did not bring the band back ({ro})")
        sell = res.sell if res.sell is not None else res.sell_spmm
        bins = sell.bins
        got = {b.layout for b in bins}
        if got != layouts:
            fail(f"{name}: the conversion gave layouts {sorted(got)}, "
                 f"the phase exists to run {sorted(layouts)}")
        if "sell_spmm" in stages and {
                b.layout for b in res.sell_spmm.bins} != {"k-major"}:
            fail(f"{name}: the sell_spmm SELL is not k-major")
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
        skips = SKIPS.get(name, {})
        if set(res.skipped) != set(skips) or any(
                word not in res.skipped[st] for st, word in skips.items()):
            fail(f"{name}: skipped {res.skipped}, the phase expects "
                 f"{skips}")
        ran = tuple(st for st in STAGES if st in stages and st not in skips)
        if tuple(res.stages) != ("serial_csr", *ran):
            fail(f"{name}: ran {tuple(res.stages)} ({res.skipped})")
        for stage in ran:
            sig = res.stages[stage].diff.significant_diffs
            if sig:
                fail(f"{name} {stage}: {sig} significant diffs vs the oracle")
        dd_errs = {s: res.stages[s].norm_err for s in ran
                   if s in DD_STAGES}
        for stage, err in dd_errs.items():
            if not err < DD_TOL:
                fail(f"{name} {stage}: norm-scaled error {err:.3e} >= "
                     f"{DD_TOL}")
        extra = ""
        if cfg_kw and cfg_kw[0].get("device_validate"):
            extra += device_validated(name, res, ran)
        if name == "headline":
            headline = (headline_spmm(res), res.csr)
        if name == "webbase_pr":
            extra += webbase_bf16(name, coo, x)
        if name == "band64_250k":
            band64_bsr(res)
            band64 = res
            st = res.format_stats["bsr"]
            extra += (f"; BSR {st['blocks']} blocks, kb {st['kb']}, fill "
                      f"{st['fill']:.4f}, {st['bytes']} B")
        now = (counts(), counts(dd_wrappers), counts(pr_wrappers),
               counts(spmm_wrappers))
        # the SELL layouts of f32 (and dd), for the PR and split stages the
        # PR kernels and the split's k-major near side, and the SpMM kernels
        want = [(0, lay) for lay in (layouts if res.sell is not None
                                     else ())]
        want += [(1, lay) for lay in got_dd]
        if "pr" in stages:
            check_pr(name, res)
            want += [(2, "pr"), (2, "pr_dd")]
        if "split" in stages:
            extra += check_split(name, res)
            want += [(2, "pr"), (2, "pr_dd"), (0, "k-major"), (1, "k-major")]
        if "sell_spmm" in stages:
            want.append((3, "k-major"))
        if "sell_sigma" in stages:
            want += [(0, b.layout) for b in res.sell_sigma.bins]
        if "bsr_spmm" in ran:
            want += [(3, "blockspec"), (3, "dma")]
        if name == "headline":
            want.append((3, "wl"))
        for which, lay in want:
            if now[which][lay] <= before[which][lay]:
                kind = ("", " dd", "", " SpMM")[which]
                fail(f"{name}: the {lay}{kind} kernel was not launched")
        if res.pr is not None:
            extra += (f"; PR panels {[p.n_rows for p in res.pr.panels]} "
                      f"bins {[p.bins for p in res.pr.panels]}, padding "
                      f"{res.pr.padding_ratio:.3f}")
        shapes = [[(b.layout, b.k, b.n_groups, b.span) for b in s.bins]
                  for s in (res.sell, res.sell_dd, res.sell_spmm)
                  if s is not None]
        best = {s: round(res.stages[s].seconds * 1e3, 4) for s in ran}
        per_call = {s: round(res.stages[s].per_call_s * 1e3, 4) for s in ran}
        fst = res.format_stats
        how = "native" if coo.nnz >= CSRMatrix._NATIVE_MIN_NNZ else "numpy"
        convert = {k[8:-2]: round(v, 2) for k, v in fst.items()
                   if k.startswith("convert_")}
        if name in ("headline", "scattered_uniform"):
            # the numpy CSR path on the same COO, for the native one's gain
            t1 = time.perf_counter()
            CSRMatrix.from_coo(coo, native=False)
            extra += (f"; CSR by numpy {time.perf_counter() - t1:.2f} s "
                      f"(not part of the phase)")
            t0 += time.perf_counter() - t1
        print(f"[{name}] {coo.nrows} rows, {coo.nnz} nnz, bins {shapes}, "
              f"padding {sell.padding_ratio:.3f}; ms, best of 3 device "
              f"rounds {best}; ms per call {per_call}; norm-scaled errors "
              f"{ {s: f'{e:.3e}' for s, e in dd_errs.items()} }{extra}; "
              f"host set-up: CSR {fst['convert_csr_s']:.2f} s ({how}), "
              f"conversions {sum(convert.values()):.2f} s {convert}; "
              f"phase {time.perf_counter() - t0:.1f} s", flush=True)
        if res.sell is not None:
            runs.append((name, res.sell, res.sell_dd, x, res.csr))
        if res.sell_spmm is not None:
            spmm_runs.append((name, res.sell_spmm, res.csr))
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
    panel = (csr, x)
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
    before_mm = {lay: spmm_wrappers[lay].accumulating for lay in got}
    Xp = np.random.default_rng(SEED).standard_normal((csr.ncols, 8),
                                                      dtype=np.float32)
    Y = SM.sell_spmm(S.device_put_sell(psell, device=dev),
                     torch.from_numpy(Xp).to(dev))
    check_spmm("panels sell_spmm", csr, Xp,
               Y.cpu().numpy().astype(np.float64))
    for lay in got:
        if wrappers[lay].accumulating <= before[lay]:
            fail(f"panels: the {lay} kernel did not accumulate")
        if dd_wrappers[lay].accumulating <= before_dd[lay]:
            fail(f"panels: the {lay} dd kernel did not accumulate")
        if spmm_wrappers[lay].accumulating <= before_mm[lay]:
            fail(f"panels: the {lay} SpMM kernel did not accumulate")
    print(f"[panels] {csr.nrows} rows, {csr.nnz} nnz, "
          f"{len(psell.panels)} panels, bins "
          f"{[[(b.layout, b.k, b.n_groups) for b in p.bins] for p in psell.panels]}, "
          f"dd norm-scaled error {dd_err:.3e}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    launches, launches_dd = counts(), counts(dd_wrappers)
    launches_pr = counts(pr_wrappers)
    launches_pr["pr_bf16"] = PR.pr_problem.launches_bf16
    launches_pr["pr"] -= launches_pr["pr_bf16"]
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
    launches_mm = counts(spmm_wrappers)
    for kind, n in launches_mm.items():
        if n == 0:
            fail(f"the {kind} SpMM kernel was never launched on the main "
                 "path")
    for lay in ("k-major", "wl"):
        if spmm_wrappers[lay].accumulating == 0:
            fail(f"the {lay} SpMM kernel never accumulated on the main path")
    print(f"main-path SpMM launches {launches_mm}, accumulating "
          f"{ {k: spmm_wrappers[k].accumulating for k in ('k-major', 'wl')} }",
          flush=True)

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
    stats = {lay: {"max_abs_err": 0.0, "best": None, "key": None}
             for lay in wrappers}
    stats_dd = {lay: {"max_abs_err": 0.0, "best": None, "key": None}
                for lay in dd_wrappers}
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size

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

    def bin_counts(b, x_rows):
        """The bin's real entries (a value that is not 0, in a slot its
        layout does not mask), the distinct x entries they read and the y
        rows they write (those the plain version sums from a value plane of
        1s at 1s of an ``x_rows``-entry x)."""
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
        n_y = int((plains[b.layout](ones, torch.ones(x_rows, device=dev))
                   > 0).sum())
        return int(real.sum()), n_x, n_y

    def take_row(st, b, nnz, row):
        """Keep ``row`` as its layout's JSON row if its bin ranks first:
        bins whose planes exceed twice the L2 (streamed from HBM even when
        run back to back, so their time can be held against the bound)
        before the others, then the most entries."""
        key = (bytes_read(b) > 2 * l2_bytes, nnz)
        if st["best"] is None or key > st["key"]:
            st["key"], st["best"] = key, row

    def bound_ms(b, xs):
        """The least time of the bin's function (:func:`bin_counts`' bytes
        over the HBM rate); returns it and the bin's real entries."""
        nnz, n_x, n_y = bin_counts(b, xs[0].numel())
        return need_ms(nnz, sum(v.element_size() for v in value_planes(b)),
                       n_x, n_y, len(xs)), nnz

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
        if phase:
            take_row(st, b, nnz, (nnz, ms_k, ms_p, tag, b.k, b.n_groups,
                                  bound, phase))

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
        if phase:
            take_row(st, b, nnz, (nnz, ms_k, ms_p, tag, b.k, b.n_groups,
                                  bound, phase))

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

    # the whole panel SpMV beside cuSPARSE on the panel phase's matrix; a
    # call queues a few launches per panel, so few reps behind the spin
    ms32 = device_time_fn(S.panel_sell_spmv,
                          S.device_put_sell(psell, device=dev),
                          torch.from_numpy(panel[1]).float().to(dev),
                          device=dev, reps=PLAIN_DD_REPS) * 1e3
    ms_dd = device_time_fn(D.panel_sell_spmv_dd,
                           D.device_put_sell_dd(psell, device=dev),
                           *(torch.from_numpy(h).to(dev)
                             for h in split_f64(panel[1])),
                           device=dev, reps=PLAIN_DD_REPS) * 1e3
    print(f"[panels] panel SpMV device time f32 {ms32:.4f} ms"
          f"{lib_note('panels', *panel, torch.float32)}; dd {ms_dd:.4f} ms"
          f"{lib_note('panels', *panel, torch.float64)}", flush=True)
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
        return need_ms(int(real.sum()), sum(v.element_size() for v in vals),
                       int(torch.unique(cols[real]).numel()), p.nrows, tables)

    pr_host, x, csr = web
    pr_stats = {}
    xt = S.device_put_x(x, csr.ncols, device=dev)
    xh, xl = D.device_put_x_dd(x, csr.ncols, device=dev)
    csr_bf16 = type(csr)(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                         quantize_bf16(csr.values))

    def routed_planes_s(dpr, dd):
        """Host seconds of the upload's index side on the card (planes,
        composed route, ``dst_col``) and of the value gathers into
        destination order, every panel, timed again after the upload."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for host, p in zip(pr_host.panels, dpr.panels):
            _, route = PR._put_index(host, dev)
            PR._routed(torch.stack([p.val_h, p.val_l], -1) if dd else p.val,
                       route)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for kind in ("pr", "pr_bf16", "pr_dd"):
        dd = kind == "pr_dd"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dpr = (PRD.device_put_pr_dd(pr_host, device=dev) if dd
               else PR.device_put_pr(pr_host, torch.bfloat16 if kind ==
                                     "pr_bf16" else torch.float32,
                                     device=dev))
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        print(f"[webbase_pr] {kind} upload {up_s:.4f} s, of which the index "
              f"side and the destination-order planes (route, dst_col, "
              f"dst_val) {routed_planes_s(dpr, dd):.4f} s (timed again "
              f"alone)", flush=True)
        xs = (xh, xl) if dd else (xt,)
        kernel = pr_wrappers["pr_dd" if dd else "pr"]
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
            planes = (nbytes(p.dst_col, p.dst_val, p.bin_table, *xs)
                      + p.y_rows * 128 * 4 * len(xs))
            bound = pr_bound_ms(p, vals, len(xs))
            if i == 0:  # the JSON line's: the first and larger panel
                pr_stats[kind] = (ms_k, ms_p, err, bound)
            print(f"[webbase_pr] {kind} panel {i} ({p.n_rows} Beneš rows, "
                  f"{p.nnz} nnz, bins {p.bins}): device kernel {ms_k:.4f} "
                  f"ms, plain {ms_p:.4f} ms; call kernel {call_k:.4f} ms; "
                  f"destination planes, x tables and y {planes} B "
                  f"({planes / ms_k / 1e9:.3f} TB/s); bound {bound:.4f} ms; "
                  f"max|k-p| {err:.3e}", flush=True)
        spmv = PRD.pr_spmv_dd if dd else PR.pr_spmv
        dev_spmv = device_time_fn(spmv, dpr, *xs, device=dev) * 1e3
        if kind == "pr_bf16":  # cuSPARSE f32 on the bf16-rounded values
            lib = lib_note("webbase_pr bf16", csr_bf16, x, torch.float32)
        else:
            lib = lib_note("webbase_pr", csr, x,
                           torch.float64 if dd else torch.float32)
        need = csr_bound_ms(csr, {"pr": 4, "pr_bf16": 2, "pr_dd": 8}[kind],
                            len(xs))
        lib_ms = library[("webbase_pr bf16", torch.float32)
                         if kind == "pr_bf16" else
                         ("webbase_pr", torch.float64 if dd
                          else torch.float32)][0]
        print(f"[webbase_pr] {kind} SpMV of both panels device time "
              f"{dev_spmv:.4f} ms, matrix bound {need:.4f} ms{lib}; "
              f"factor against cuSPARSE {dev_spmv / lib_ms:.3f}x (panel 0 "
              f"alone {pr_stats[kind][0] / lib_ms:.3f}x)", flush=True)
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

    # ---- the SpMM kernels against their plain versions, on the card ----
    mm_stats = {k: {"max_abs_err": 0.0, "best": None} for k in spmm_wrappers}
    cusparse_mm = {}

    def cusparse_spmm(name, csr, X):
        """Device ms of ``torch.sparse_csr_tensor(...) @ X`` (cuSPARSE SpMM,
        f32 values and X, int32 indices) on the phase's whole matrix; timed
        once per phase and width."""
        key = (name, X.shape[1])
        if key not in cusparse_mm:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                A = torch.sparse_csr_tensor(
                    torch.from_numpy(csr.row_ptr.astype(np.int32)),
                    torch.from_numpy(csr.col_idx.astype(np.int32)),
                    torch.from_numpy(csr.values).float(), size=csr.shape,
                    device=dev, check_invariants=False)
                Xd = torch.from_numpy(np.ascontiguousarray(X)).float().to(dev)
                cusparse_mm[key] = device_time_fn(lambda: A @ Xd,
                                                  device=dev) * 1e3
            del A, Xd
        return cusparse_mm[key]

    def rhs_copy(y0):
        """A copy of a SpMM y in the kernels' layout (padded rows)."""
        y = SM._rhs_buffer(y0.shape[0], y0.shape[1], dev)
        y.copy_(y0)
        return y

    def check_spmm_bin(tag, b, xt, y0, phase):
        """A bin through its SpMM kernel, storing and adding onto ``y0``,
        against its plain version; timed (and a candidate for the JSON row)
        when ``phase`` is given."""
        rhs = xt.shape[1]
        kernel, plain = spmm_wrappers[b.layout], SM._PLAIN[b.layout]
        want = plain(b, xt)
        atol = ATOL_REL * float(want.abs().max())
        rows = b.group_ids.long()
        err = 0.0
        for accumulate in (False, True):
            y = rhs_copy(y0)
            kernel(b, xt, y, accumulate=accumulate)
            got = y.view(-1, 8, 128, rhs)[rows]
            if accumulate:
                got = got - y0.view(-1, 8, 128, rhs)[rows]
            e = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=RTOL, atol=atol):
                fail(f"{tag} ({b.layout} SpMM, accumulate={accumulate}): "
                     f"max|k-p| = {e}")
            err = max(err, e)
        st = mm_stats[b.layout]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if phase is None:
            return
        y = rhs_copy(y0)
        ms_k = device_time_fn(kernel, b, xt, y, device=dev) * 1e3
        ms_p = device_time_fn(plain, b, xt, device=dev,
                              reps=PLAIN_SPMM_REPS) * 1e3
        call_k = time_fn(kernel, b, xt, y, device=dev) * 1e3
        nnz, n_x, n_y = bin_counts(b, xt.shape[0])
        bound, by = spmm_need(nnz, b.as_.element_size(), n_x, n_y, rhs)
        planes = nbytes(b.ja, b.as_) + (n_x + n_y) * rhs * 4
        print(f"{tag} {b.layout} SpMM R={rhs} k={b.k} groups={b.n_groups}: "
              f"device kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms; call "
              f"kernel {call_k:.4f} ms; planes, x and y rows {planes} B "
              f"({planes / ms_k / 1e9:.3f} TB/s); "
              f"{2 * nnz * rhs / ms_k / 1e6:.1f} GFLOPS; bound {bound:.4f} "
              f"ms ({by}, {nnz} entries); max|k-p| {err:.3e}", flush=True)
        if rhs == SPMM_RHS and (st["best"] is None or nnz > st["best"][0]):
            st["best"] = (nnz, ms_k, ms_p, tag, b.k, b.n_groups, bound, by,
                          phase)

    def columns_equal_spmv(tag, d, X):
        """Column j of the SpMM is the SpMV kernel on X[:, j], bit for
        bit."""
        Y = SM.sell_spmm(d, SM.device_put_x_multi(X, d.ncols, device=dev))
        for j in range(X.shape[1]):
            y = S.sell_spmv(d, S.device_put_x(X[:, j], d.ncols, device=dev))
            if not torch.equal(Y[:, j], y):
                fail(f"{tag}: SpMM column {j} differs from the SpMV kernel "
                     f"by up to {(Y[:, j] - y).abs().max().item()}")
        print(f"{tag}: the {X.shape[1]} SpMM columns equal the SpMV kernel "
              "bit for bit", flush=True)

    def spmm_phase(name, d, csr, rhs, phase, bf16=None):
        """Every bin of ``d`` at ``rhs`` right-hand sides, the whole SpMM
        against its plain assembly, its device time beside cuSPARSE SpMM;
        ``bf16``: the same host SELL, checked with bf16 values."""
        X = np.random.default_rng(SEED).standard_normal((csr.ncols, rhs),
                                                        dtype=np.float32)
        xt = SM.device_put_x_multi(X, d.ncols, device=dev)
        y0 = rhs_copy(torch.randn(d.num_groups * 1024, rhs, device=dev))
        for i, b in enumerate(d.bins):
            check_spmm_bin(f"[{name}] bin {i}", b, xt, y0, phase)
        Y = SM.sell_spmm(d, xt)
        Yp = SM.sell_spmm_plain(d, xt)
        if not torch.allclose(Y, Yp, rtol=RTOL,
                              atol=ATOL_REL * float(Yp.abs().max())):
            fail(f"[{name}] sell_spmm R={rhs}: the kernels disagree with "
                 "the plain versions")
        ms = device_time_fn(SM.sell_spmm, d, xt, device=dev) * 1e3
        lib = cusparse_spmm(name, csr, X)
        print(f"[{name}] sell_spmm R={rhs} device time {ms:.4f} ms "
              f"({2 * csr.nnz * rhs / ms / 1e6:.1f} GFLOPS); cuSPARSE SpMM "
              f"{lib:.4f} ms", flush=True)
        if bf16 is not None:
            db = S.device_put_sell(bf16, torch.bfloat16, device=dev)
            for i, b in enumerate(db.bins):
                check_spmm_bin(f"[{name}] bf16 bin {i}", b, xt, y0, None)
            del db

    for name, sell_mm, csr in spmm_runs:
        d = S.device_put_sell(sell_mm, device=dev)
        big = name == "banded_adversarial"
        spmm_phase(name, d, csr, SPMM_RHS, name, sell_mm if big else None)
        if big:
            columns_equal_spmv(f"[{name}] k-major", d, np.random.default_rng(
                SEED).standard_normal((csr.ncols, SPMM_RHS),
                                      dtype=np.float32))
        del d
        torch.cuda.empty_cache()
    d, csr = headline
    for rhs in HEADLINE_RHS:
        hsell = runs[[r[0] for r in runs].index("headline")][1]
        spmm_phase("headline", d, csr, rhs, "headline",
                   hsell if rhs == SPMM_RHS else None)
    columns_equal_spmv("[headline] wl", d, np.random.default_rng(
        SEED).standard_normal((csr.ncols, SPMM_RHS), dtype=np.float32))
    del d, headline
    torch.cuda.empty_cache()
    dps = S.device_put_sell(psell, device=dev)
    Xd = torch.from_numpy(Xp).to(dev)
    for p, dsell in enumerate(dps.panels):
        c0, c1 = dps.bounds[p], dps.bounds[p + 1]
        xt = SM.pack_x_multi(Xd[c0:c1], c1 - c0)
        y0 = rhs_copy(torch.randn(dps.num_groups * 1024, 8, device=dev))
        for i, b in enumerate(dsell.bins):
            check_spmm_bin(f"[panels] spmm panel {p} bin {i}", b, xt, y0,
                           None)

    # band64_250k's blocks through both BSR routes against the plain version
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the plain BSR "
             "version would not be IEEE f32")
    bsr_rows = {}
    csr, bsr = band64.csr, band64.bsr
    n_x = int(np.unique(csr.col_idx).size)
    n_slots = bsr.n_block_rows * bsr.kb
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = BSR.device_put_bsr(bsr, dtype, device=dev)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        BSR.tile_masks(d.blocks)
        torch.cuda.synchronize()
        mask_s = time.perf_counter() - t0
        # byte a of a slot's mask: sub-tile row a; their OR: the strips
        rows = d.tile_mask.cpu().numpy().view(np.uint8).reshape(-1, 8)
        kept = int(np.unpackbits(rows).sum())
        strips = int(np.unpackbits(np.bitwise_or.reduce(rows, 1)).sum())
        real = int(rows.any(1).sum())
        print(f"[band64_250k] bsr {str(dtype)[6:]} upload {up_s:.4f} s, of "
              f"which tile_mask {mask_s:.4f} s (timed again alone); "
              f"{n_slots} slots ({real} with a nonzero), kept 16x16 "
              f"sub-tiles {kept} of {64 * n_slots} "
              f"({kept / (64 * n_slots):.4f}; {kept / max(64 * real, 1):.4f} "
              f"of the non-pad slots), live 128x16 strips {strips} of "
              f"{8 * n_slots}; FLOP multiplied at B=128 "
              f"{kept * 2 * 16 * 16 * 128 / 1e9:.3f} G against "
              f"{n_slots * 2 * 128 ** 3 / 1e9:.3f} G dense and "
              f"{2 * csr.nnz * 128 / 1e9:.3f} G useful", flush=True)
        elem = d.blocks.element_size()
        for rhs in BSR_RHS:
            X, xp, _, _ = bsr_inputs(csr, dtype, rhs)
            want = BSR.bsr_spmm_plain(d, xp)
            atol = ATOL_REL * float(want.abs().max())
            ms_p = device_time_fn(BSR.bsr_spmm_plain, d, xp, device=dev,
                                  reps=PLAIN_SPMM_REPS) * 1e3
            lib = cusparse_spmm("band64_250k", csr, X)
            need, by = spmm_need(
                csr.nnz, elem, n_x, csr.nrows, rhs, elem,
                F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S)
            dense = n_slots * 2 * 128 * 128 * rhs / F32_FLOP_PER_S * 1e3
            for route, kernel in BSR.ROUTES.items():
                got = BSR.bsr_spmm(d, xp, route=route)
                e = (got - want).abs().max().item()
                if not torch.allclose(got, want, rtol=RTOL, atol=atol):
                    fail(f"[band64_250k] {route} {dtype} B={rhs}: the kernel "
                         f"disagrees with the plain version, max|k-p| = {e}")
                y = torch.empty(bsr.n_block_rows * 128, rhs, device=dev)
                ms_k = device_time_fn(kernel, d, xp, y, device=dev) * 1e3
                call_k = time_fn(kernel, d, xp, y, device=dev) * 1e3
                st = mm_stats[route]
                st["max_abs_err"] = max(st["max_abs_err"], e)
                print(f"[band64_250k] bsr {route} {str(dtype)[6:]} B={rhs}: "
                      f"device kernel {ms_k:.4f} ms "
                      f"({2 * csr.nnz * rhs / ms_k / 1e6:.1f} useful "
                      f"GFLOPS, {kept * 2 * 16 * 16 * rhs / ms_k / 1e9:.2f} "
                      f"TFLOP/s multiplied), call {call_k:.4f} ms; plain "
                      f"{ms_p:.4f} ms; cuSPARSE SpMM (f32) {lib:.4f} ms; "
                      f"bound {need:.4f} ms ({by}); dense-block FLOP at "
                      f"the f32 rate {dense:.4f} ms; factor against "
                      f"cuSPARSE {ms_k / lib:.3f}x; max|k-p| "
                      f"{e:.3e}", flush=True)
                if dtype == torch.float32 and rhs == BSR_RHS[0]:
                    bsr_rows[route] = (ms_k, ms_p, need, by, lib)
        del d
        torch.cuda.empty_cache()

    # ---- the probe kernels against their plain versions, at the bandwidth
    # phase's sizes; small integers, so they must agree bit for bit ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ints = {"generator": gen, "device": dev}
    nr = 1 << 20  # rows of 128 f32: 512 MB
    buf = BW.small_ints((nr, 128), torch.float32, **ints)
    seed_t = BW.small_ints((8, 128), torch.float32, **ints)
    bw_rows = {}

    def probe_check(tag, kernel, plain, args, kw=None, plain_reps=20):
        """``kernel`` and ``plain`` on ``args``: equal, or fail; returns
        their device times (ms)."""
        kw = kw or {}
        got, want = kernel(*args, **kw), plain(*args, **kw)
        if not torch.equal(got, want):
            fail(f"[bandwidth] {tag}: the kernel disagrees with its plain "
                 f"version by up to {(got - want).abs().max().item()}")
        ms_k = device_time_fn(lambda: kernel(*args, **kw), device=dev) * 1e3
        ms_p = device_time_fn(lambda: plain(*args, **kw), device=dev,
                              reps=plain_reps) * 1e3
        return ms_k, ms_p

    def probe_line(tag, ms_k, ms_p, nbytes, lib=None):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[bandwidth] {tag}: kernel {ms_k:.4f} ms "
              f"({nbytes / ms_k / 1e9:.3f} TB/s), plain {ms_p:.4f} ms, "
              f"bound {bound:.4f} ms"
              + ("" if lib is None else f", PyTorch {lib:.4f} ms")
              + "; equal bit for bit", flush=True)
        return bound

    def fold_lib(a):
        return device_time_fn(lambda: a.view(-1, 8, 128).sum(0), device=dev) \
            * 1e3

    ms_k, ms_p = probe_check("read f32", BW.bw_read, BW.bw_read_plain,
                             (buf, seed_t))
    lib = fold_lib(buf)
    bw_rows["bw_read"] = (ms_k, ms_p, probe_line(
        "read f32", ms_k, ms_p, nbytes(buf), lib), lib, "read f32, 512 MB")
    for dtype in (torch.int32, torch.int16, torch.int8):
        rows = nbytes(buf) // (128 * dtype.itemsize)
        plane = BW.small_ints((rows, 128), dtype, **ints)
        ms_k, ms_p = probe_check(f"read {dtype}", BW.bw_read,
                                 BW.bw_read_plain, (plane, seed_t))
        probe_line(f"read {str(dtype)[6:]}, 512 MB", ms_k, ms_p,
                   nbytes(plane), fold_lib(plane))
        del plane
    half = buf[: nr // 2]
    ja = BW.small_ints((nr // 2, 128), torch.int32, **ints)
    ms_k, ms_p = probe_check("read2", BW.bw_read, BW.bw_read_plain,
                             (half, seed_t, ja))
    probe_line("read2 f32 + int32, 2 x 256 MB", ms_k, ms_p,
               nbytes(half, ja))
    del ja
    out = torch.empty_like(half)
    ms_k, ms_p = probe_check("copy", lambda b, s: BW.bw_copy(b, s, out),
                             BW.bw_copy_plain, (half, seed_t))
    s00 = seed_t[0, 0]
    lib = device_time_fn(lambda: torch.add(half, s00, out=out),
                         device=dev) * 1e3
    bw_rows["bw_copy"] = (ms_k, ms_p, probe_line(
        "copy 256 MB (read + write)", ms_k, ms_p, 2 * nbytes(half), lib),
        lib, "copy, 256 MB read + 256 MB written")
    del out
    lib = fold_lib(buf)
    for ch, nb in BW.ASYNC_CONFIGS:
        tag = f"cp.async {ch}-row chunks x {nb} stages"
        ms_k, ms_p = probe_check(tag, BW.bw_read_async, BW.bw_read_async_plain,
                                 (buf, seed_t), {"chunk_rows": ch, "nbuf": nb})
        bound = probe_line(tag + ", 512 MB", ms_k, ms_p, nbytes(buf), lib)
        if (ch, nb) == BW_JSON_ASYNC:
            bw_rows["bw_read_async"] = (ms_k, ms_p, bound, lib, tag)
    ng, k = 240, 64  # the JAX probe's kernelsim: 240 groups, K=64
    for tag, kw, xrows in (
            ("span4", {"span": 4}, 2048),
            ("nocompute", {"span": 4, "compute": False}, 2048),
            ("span4_packed16", {"span": 4, "packed": True}, 2048),
            ("span1", {"span": 1}, 2048), ("span8", {"span": 8}, 2048),
            ("span4_xtab8mb", {"span": 4}, 16384)):
        qb, xk, code, as_ = BW.kernelsim_inputs(
            ng, k, xrows, kw["span"], packed=kw.get("packed", False), **ints)
        ms_k, ms_p = probe_check(f"kernelsim {tag}", BW.bw_kernelsim,
                                 BW.bw_kernelsim_plain,
                                 (qb, xk, code, as_, seed_t),
                                 {"k": k, **kw}, plain_reps=3)
        # the function's bytes: planes, window indices, the distinct x
        # entries its codes gather (none without compute), its y
        n_x = 0
        if kw.get("compute", True):
            c = BW._codes(code, ng, k // 8, kw.get("packed", False))
            n_x = int(torch.unique((qb.view(ng, 8, k // 8, 1, 1).long()
                                    + (c >> 7)) * 128 + (c & 127)).numel())
            del c
        moved = nbytes(qb, code, as_) + 4 * n_x + 4 * ng * 8 * 128
        bound = max(probe_line(f"kernelsim {tag} ({n_x} x entries)", ms_k,
                               ms_p, moved),
                    2 * as_.numel() / F32_FLOP_PER_S * 1e3)
        if tag == "span4":
            bw_rows["bw_kernelsim"] = (ms_k, ms_p, bound, None,
                                       "kernelsim span 4, 240 groups, K=64")
        del qb, xk, code, as_
    del buf, half
    torch.cuda.empty_cache()

    summary = []
    for key, (kname, replaces) in BW_KERNELS.items():
        ms_k, ms_p, bound, lib, where = bw_rows[key]
        print(f"{kname}: device times at {where} (bandwidth phase)")
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/bw_probe.cu", "replaces": replaces,
            "launches": launches_bw[key], "max_abs_err": 0.0, "ms": ms_k,
            "plain_ms": ms_p, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib})
    for key, (variant, replaces) in KP_KERNELS.items():
        r = kp_recs[variant]
        print(f"{key}: device times at {variant} (kernel_probe phase, "
              f"{r['entries']} entries)")
        summary.append({
            "name": key, "route": "cuda",
            "source": f"{PKG}/csrc/kernel_probe.cu", "replaces": replaces,
            "launches": launches_kp[key], "max_abs_err": 0.0, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for table, kernels, run_stats, launched, lib_dtype in (
            ("", KERNELS, stats, launches, torch.float32),
            (" dd", DD_KERNELS, stats_dd, launches_dd, torch.float64)):
        for lay, (kname, source, replaces) in kernels.items():
            nnz, ms_k, ms_p, tag, k, ng, bound, phase = \
                run_stats[lay]["best"]
            hbm = "" if run_stats[lay]["key"][0] else ", L2-resident"
            print(f"{kname}: device times at its largest main-path bin "
                  f"({tag}, k={k}, {ng} groups, {nnz} entries{hbm},"
                  f"{table or ' f32'} values)")
            summary.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched[lay],
                "max_abs_err": run_stats[lay]["max_abs_err"], "ms": ms_k,
                "plain_ms": ms_p, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": library[phase, lib_dtype][0]})
    for kind, (kname, source, replaces) in PR_KERNELS.items():
        ms_k, ms_p, err, bound = pr_stats[kind]
        lib_key = {"pr": ("webbase_pr", torch.float32),
                   "pr_bf16": ("webbase_pr bf16", torch.float32),
                   "pr_dd": ("webbase_pr", torch.float64)}[kind]
        summary.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_pr[kind],
            "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library[lib_key][0]})
    for key, (kname, source, replaces) in SPMM_KERNELS.items():
        if key in BSR.ROUTES:
            ms_k, ms_p, bound, by, lib = bsr_rows[key]
            where = f"band64_250k f32, B={BSR_RHS[0]}"
        else:
            nnz, ms_k, ms_p, tag, k, ng, bound, by, phase = \
                mm_stats[key]["best"]
            lib = cusparse_mm[phase, SPMM_RHS]
            where = f"{tag}, k={k}, {ng} groups, {nnz} entries, R={SPMM_RHS}"
        print(f"{kname}: device times at its largest main-path run "
              f"({where}, f32 values)")
        summary.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_mm[key],
            "max_abs_err": mm_stats[key]["max_abs_err"], "ms": ms_k,
            "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
            "library_ms": lib})
    print(f"smoke ran {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
