#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main paths on one GPU: the card's
bandwidth and kernel-variant probes, SELL SpMV (f32, bf16 and
double-double), the benchmark harness's HLL, CSR, ELL and SELL-sigma stages
and RCM reordering, the PR layout (f32, bf16 values and double-double) and
the locality split, ``auto_device_op``, multi-RHS SpMM (SELL k-major and
wl, 128x128 BSR), the solvers over those kernels (CG and PCG,
``cg_multi``, BiCGSTAB, GMRES, PageRank, power iteration, Lanczos, subspace
iteration, iterative refinement), the sweep CLI with the measured
autotuner, the K-bin ladder sweep, resume and profiling, and the
multi-device layer (``parallel/``: ranks on ``torch.distributed`` device
meshes, gloo ranks sharing the card and one NCCL rank per card), the
entry programs (``entry.entry()``, ``entry.dryrun_multichip(n)`` and the demo)
and the flagship line (``bench/flagship.py``, bench.py's port).

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
                      at R=8 and R=16 on the raw X, which the wl SpMM kernel
                      reads in place (every bin must be wl), and the fp64
                      entry ``sell_spmv_dd_f64`` on its dd SELL (the x
                      split and y join kernels around the wl dd launch),
                      bit for bit the halves' path;
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
                      probes/bsr_spmm_tpu.py: ``sell`` and ``sell_dd``
                      (forced to k-major: the main path's k-major bin that
                      streams from HBM, f32 and dd; the dd bin, of one
                      lane a row, must be compacted), ``sell_spmm`` and
                      ``bsr_spmm`` (B=128); then ``bsr_spmm`` on its
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
panels (k-major and wl bins, their columns rebased onto the whole x)
through ``panel_sell_spmv`` (the plan's joint launches into slices, then
``panel_reduce``; f32, bf16 and dd) and ``sell_spmm`` (R=8, every bin
accumulating); and ``auto_device_op`` on the mixed and
road_scattered matrices and on power_law(200_000, 3), which must pick
"sell", "split" and "pr" and whose ``matvec`` must launch the kernels of
what it picked.

Then the flagship phase (:func:`flagship_phase`): bench.py's line through
``bench/flagship.py``'s three per-matrix functions at full size on the
headline's, banded_adversarial's and road_scattered's COOs (no matrix is
generated twice; x = 1), its record printed as ``python -m ...bench`` prints
it and its ``valid`` true, each conversion's layouts wl, sb-major and
sb-list. The SELL counters are set to 0 just before it and read just after:
the wl kernel must launch in f32, bf16 and dd, sb-major in f32 and dd, and
sb-list in f32; the phase's launches are added to the JSON summary's.

Then the solver phase (:func:`solver_phase`): the solvers of ``solvers/`` at
full size over the kernels, with the launch counters set to 0 just before it
and read just after (and added to the main path's in the JSON summary). Its
matrices, each of which must convert to the SELL layouts named:

* spd_fem3d:  the headline's fem_3d(60, 60, 60, dof=3) made SPD as the JAX
              solver tests make theirs, (M + M^T)/2 plus the largest
              absolute row sum + 1 on the diagonal: wl; f32, bf16 and dd;
* cfd_like:   the suite's cfd_multidof(180, 180, dof=5, seed=15) plus the
              same shift, nonsymmetric: sb-major and wl; f32 and dd;
* pagerank:   ``pagerank_operator`` of |webbase_like(1_000_000, 3, seed=9)|:
              k-major and sg; f32 and dd;
* spd_band:   band64's banded(250_000, 64, 64, seed=11) made SPD, on 128x128
              blocks (``bsr_spmm``, blockspec).

On spd_fem3d it runs ``cg_sell`` (f32), PCG with ``jacobi_preconditioner`` and
with a degree-4 ``chebyshev_preconditioner`` on ``lanczos_bounds``, CG over
``sell_spmv_dd_f64``, ``iterative_refinement`` (CG over the bf16 SELL at
1e-2, 50 iterations at most, dd residuals, to 1e-12), ``cg_multi`` (R=16) and
``subspace_iteration`` (k=8, 50 iterations at most) over ``sell_spmm``,
``power_iteration``, ``lanczos`` and ``lanczos_extremal`` (m=30); on cfd_like
BiCGSTAB and GMRES(30) in f32 and GMRES(30) in dd; PageRank in f32 and dd;
on spd_band ``cg_multi`` (R=16) over ``bsr_spmm``. Each is held to the host's
fp64 oracle: the true relative residual at most 10 times the tolerance (per
column for ``cg_multi``; 1e-12 for refinement); PageRank within 1e-5 in L1
(dd: 1e-9) of the same iteration in fp64 on the host, and its sum as close
to 1; power iteration's eigenvalue within 1e-5 of the host's Rayleigh
quotient of its vector; Lanczos ``||V V^T - I|| < 1e-4`` and its extremal
Ritz values inside the Gershgorin interval; subspace iteration's Ritz values
within 1e-4 of the host's ``eigvalsh(Q^T A Q)`` and its block residual within
1e-3 of the host's (relative, floored at 1e-3). Each solve runs once to warm
up and once timed between synchronizations; its line gives the iterations,
the matvecs, the wall time of the solve and of an iteration, one matvec's
device time (``device_time_fn`` on the same container) and the share of the
solve outside the matvecs. The wl kernel (f32, bf16, dd), the wl SpMM, the
BSR blockspec kernel and the kernels of cfd_like's and pagerank's layouts
(f32 and dd) must launch in the phase.

Then the sweep phase (:func:`sweep_phase`): the sweep and tune layer at full
size through ``bench.cli.main``, in process, with the SELL kernels' launch
counters set to 0 just before it and read just after (the launches of the
stages and the ladder sweep are added to the main path's in the JSON
summary; the tuner's timing launches are printed apart). Call A sweeps the bench suite's kkt_like
(1,057,453 rows, 22,711,437 nnz: above the tuner's 20M-nnz cap, so it tunes
on a row prefix) and cfd_like (162,000 rows, 7,236,100 nnz) with
``--autotune --ladder-sweep`` and the stages ``serial_hll``, ``csr``,
``ell``, ``sell``, ``sell_bf16``, ``sell_dd`` and ``hll``; the tuner converts,
uploads and times its 10 default candidates on the card (forced k-major,
sb-major, sb-list and wl among them) and the bin assembly of the winner.
Call B sweeps the same two and amazon_like (k-major and sg) with ``--resume
--profile-dir``. Both must exit 0; every CSV header must be the reference
schema's the port copied; every stage and ladder row must have
``significant_diffs == 0`` and every ``sell_dd`` stage a norm-scaled error
below 1e-12; every SELL that the stages, the ladder sweep and the tuner
run (each candidate and the assembly A/B) must agree with its plain
version at its first call, as in the SELL phases (f32 within rtol 1e-5,
dd within 1e-12 of max|y|); each matrix's tuner table must hold the 10
candidates, each measured or refused by a guard; call B must skip the two
checkpointed matrices and run amazon_like; the k-major, wl, sb-major,
sb-list and sg kernels and the dd kernels of each layout the ``sell_dd``
stages ran must launch, by the stages or the tuner. It prints each tuner table (measured ms, padding,
bins), each pick and assembly against the default ladder's time (the
converter's ``layout="auto"``), the ladder rows, the SELL stages,
``report.best_table`` of the output and the number of CUDA kernel events in
amazon_like's trace (reported, never checked).

Then the multi-device phase (:func:`multidevice_phase`, 107 s on the card
alone): four gloo ranks share ``cuda:0`` (``parallel.launch.spawn``), each
handed only its own host shard of shards built here once, and run the
headline's held wl SELL in 4 row shards (``sell_spmv_spmd``, and
``sell_spmm_spmd`` at R=16), banded_adversarial in 4 row shards (sb-major;
each rank's kernels also held against their plain versions), in 4 column
shards (``sell_spmv_spmd_cols``) and as the row-, 2x2- and column-sharded
ELL of ``sharding.py``, scattered_uniform in 4 row shards (sg and
accumulating k-major bins), webbase_like's PR panels (``pr_spmv_spmd``),
road's locality split (``split_spmv_spmd``) and band64_250k's block-rows
(``bsr_spmm_spmd``, B=128); then banded_adversarial in SELL shards on
``[cuda:0] * 4`` from one process (``shard_sell_rows``), on
``torch.cuda.device_count()`` NCCL ranks, and ``python -m
...bench.cli --suite-entry cfd_like --scale-sweep`` at that count. Every
path must give every rank the same y, no significant difference from the
fp64 oracle, and agree with the same matrix's single-device kernels in
this run within 1e-5 of max|y| (SpMM: per column); it prints each rank's
kernel device time, the collective's time, the call and its wall, the
partition's imbalance and the bytes each rank holds. The ranks count their
own launches; the phase adds them to the JSON summary's.

Then the entry-programs phase (:func:`entry_programs_phase`):
``entry.entry()`` on ``cuda:0`` (its y equal to the plain k-major version
bit for bit, no significant difference from the fp64 oracle,
``sell_k_major`` launched),
``entry.dryrun_multichip(4)`` on four gloo ranks sharing the card and
``dryrun_multichip(torch.cuda.device_count())`` on one NCCL rank a card
(every path of the JAX dryrun OK with the same y on every rank and its
kernels launched; the 2-D ELL path reported as skipped at n = 1), and
``python -m ...demo`` in a subprocess (exit 0, every tier without a
significant difference, refinement within 1e-11, the SELL f32 time beside
the card's name). The launches of ``entry()`` and of the ranks are added to
the JSON summary's.

Then the split-join phase (:func:`split_join_phase`): the dd entry's x split
and y join kernels (``dd_prepare_x``, ``dd_join_y``) at fem3d_cube's 648,000
columns, bit for bit their plain versions, the PyTorch composition they
replaced, with each one's device and host times.

Then the CG phase (:func:`cg_step_phase`), twice: CG's fused kernels
(``cg_init``, ``cg_alpha``, ``cg_step``, ``cg_dir`` of ``csrc/cg_step.cu``)
at fem3d_cube's 648,000 rows in f32 and in f64, each against its plain
version (the eager loop's ops) on the state the kernels before it left,
with each one's device time, bound (bytes) and the plain version's time;
their launches are the solver phase's (its CG solves run them, the dd one
the f64 instantiations), a JSON row each (``cg_init``, ..., and
``cg_init_f64``, ...).

On the main path too, the row-map phase (:func:`row_map_phase`): GAP's kron
graph at SCALE 16, converted by the exported ``SellMatrix``'s row-order
rule (heavy rows split, rows sorted), through ``sell_spmv`` and
``sell_spmv_dd_f64``, y in the caller's order by the gather kernels of
``csrc/row_map.cu`` (``row_gather``, ``row_gather_dd``), each bit for bit
its plain version and within rounding of the oracle; then the gather alone
on kron at SCALE 20's row map (its degrees split and sorted by the rule),
bit for bit its plain version, with its device time, bound and the plain
version's time. Their launches count in the JSON summary.

Every stage and every ``matvec`` must show no significant difference from
the fp64 oracle (bf16: the oracle of the bf16-quantized matrix; SpMM: on 4
sampled columns); the dd stages also a norm-scaled error ``max|y - y_ref| /
max|y_ref|`` below 1e-12. The SELL phases run f32, bf16 and dd (``sell_dd``, on
the same SELL as ``sell``: the dd kernels take slot-packed sg bins),
band64_250k f32 and dd, webbase_pr only f32. The kernels' launch counters
are reset before the phases and read after them and the panel phase, before
``auto_device_op``;
every kernel and every dd kernel, the k-major kernel of
both precisions in accumulate mode, the dd entry's x split and y join, the
PR kernel with bf16 values, every
SpMM kernel (both BSR routes among them) and both SELL SpMM kernels in
accumulate mode must have been launched. The probe kernels' counters are
reset before the bandwidth phase and read after it. Each phase prints its
host set-up: the CSR conversion (the native converter from 2,000,000
entries), the sum of its conversions and the phase's wall time.

Then every bin of every phase, banded_adversarial and road_scattered also with
int16 sb index planes, is run through its kernel, storing and accumulating, and
through its plain PyTorch version on the card; they must agree within
rtol=1e-5, atol=1e-5*max|y| (f32 sums in another order), or for the dd kernels
within 1e-12*max|y| on the fp64-combined result (dd sums in another order); the
k-major, wl, sb-list and sg kernels (dd: k-major, wl, sb-list and sg), whose
plain versions add in the kernels' order and rounding, bit for bit, each
k-major bin whether its rows are split over lanes or not (the smoke prints
each bin's lanes a row). Each compacted bin's kernel (wl, and sb-list with
int32 planes; f32 and dd; and dd k-major bins of one lane a row) must also
return what the padded layout before compaction returned
(``wl_padded_plain``, ``sb_list_padded_plain``, ``k_major_padded_plain_dd``:
every slot, pads included) bit for bit, and each compacted sg bin's (f32,
bf16) the padded tiles' sums (``sg_padded_plain``) within f32 rounding, the
same products in another order; the smoke prints each such bin's padded (sg: its
real tiles') and compacted slots and bytes, the headline's upload seconds,
and scattered_uniform's dd SpMV bin by bin. Every SpMV runs its launch plan
(``ops/sell.py``: the bins that share a kernel go out as one joint launch):
each phase counts one SpMV's kernel launches, which must be the plan's, and
prints them with ``sell_spmv_launches`` (the zero fills, x tables and pair
table included), the plan's own tables and the upload's peak device bytes;
each joint launch of more than one bin (and each panel launch, its group ids
rebased to its slice) must equal its joint bin's plain version, bit for bit
where the layout's kernel does, and prints its device time beside its bins'
own; ``panel_reduce`` and ``panel_reduce_dd`` must equal their plain versions
bit for bit on the panel phase's slices, and must launch on the main path. A zero-rule phase then runs, for
each SELL layout (k-major, sb-major, sb-list with int32 and int16 planes, wl,
sg in slots and rows mode) in f32 and dd, a matrix whose one entry of some
column is stored as 0, with x infinite at that column, through the kernels:
every row must be finite and equal the fp64 oracle of the matrix without
that entry (f32 at the tolerance above, dd within 1e-12*max|y|). So are
webbase_pr's PR panels through the PR and PR-dd kernels, road_scattered's
split (its K=1 far problem through the PR kernels, and the composite), and
band64_250k's blocks through both BSR routes (f32 and bf16, B=128 and 512, at
the f32 tolerance: the plain version widens bf16 exactly as the kernels do,
so only the order of the f32 sums differs). Every bin of the SELL SpMM runs
(the sell_spmm SELLs at R=16, the headline's wl bins at R=8 and 16; f32, and
bf16 values on the headline and banded_adversarial) must equal its plain
version bit for bit, storing and adding; each k-major SpMM bin prints how
many of its blocks ran on x staged in shared memory and how many on the x
table, and where some staged, its time with staging off; band64_250k's and
banded_adversarial's k-major bins also run at R = 1, 4, 8 and 32, and the
headline's wl bins at R = 1, 4, 8, 16 and 32 (also on the raw X where R is a
multiple of 4, and ``sell_spmm`` on the raw X equal to it on the table), each
wl bin with its NW, L, the kernel's registers and spills (the build's
``-Xptxas -v`` output) and its bound at each R. Column j
of each SELL SpMM result must equal the SpMV kernel on X[:, j] bit for bit on
the headline and banded_adversarial. Kernel and
plain version are each timed twice: device time (CUDA events around calls
queued back to back behind a spin kernel, per call) and call time (CUDA
events around each call, host included); the plain versions that add slot
step by slot step (k-major, wl, sb-list and sg, the SpMM and dd twins among
them), which queue a few kernels for every step, only by call time over
``PLAIN_SEQ_REPS`` calls. Beside each phase's SpMV, the
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

The JSON summary's ``ms`` is a device time and ``plain_ms`` one too (a call
time for a plain version that adds step by step), at each kernel's main-path
bin with the most entries among those whose planes exceed twice the
L2 (so they stream from HBM and their time can be held against the bound; the
largest bin where none does; PR: webbase_pr's panel 0; SELL SpMM at R=16; BSR:
band64_250k at B=128) with f32 (or dd) values and int32 index planes;
``bound_ms`` is the least time the card could take for the function that bin
computes: the larger of its bytes over 3.35 TB/s (its real entries' values and
4 B columns (wl: the 2-byte code its compacted planes need), each distinct x
entry (per x table or right-hand side) they read and each y entry they write,
moved once) and its useful FLOP (2 per entry and right-hand side) over the 67
TFLOP/s f32 rate; ``bound_by`` says which. SpMV does ~2 FLOP per entry f32 and
~20 dd, so bytes bind; beside the BSR kernels the smoke prints band64's kept
16x16 sub-tiles (those ``tile_mask`` marks nonzero, the ones the kernels
multiply), the FLOP they make and the dense-block FLOP (every stored block
multiplied whole). It also prints the upload seconds of the PR problems'
destination-order planes and of ``tile_mask``, and each PR and BSR kernel's
factor against cuSPARSE in the same call. Padding, index tables and the
layout's own planes are not counted; the bytes the layout's planes hold are
printed beside it, and is the SELL rows' ``plane_bytes``. ``library_ms`` is the
cuSPARSE time of the bin's phase.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``. Any failure exits non-zero before them;
so does a machine without CUDA, or a directory without the package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
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
# the k-major, wl, sb-list and sg plain versions add slot step by slot step,
# a few kernels a step (the headline's wl bins ~1,400 a call in f32, ~2,800
# dd): more than fit behind device_time_fn's spin, so they get call times
# over few calls
PLAIN_SEQ_REPS = 3
# layouts whose plain versions add in the kernel's order: kernel == plain bit
# for bit
SEQ_LAYOUTS = ("k-major", "wl", "sb-list", "sg")
SEQ_LAYOUTS_DD = ("k-major", "wl", "sb-list", "sg")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
F32_FLOP_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
SPMM_RHS = 16              # R of the SELL SpMM runs (the sell_spmm stage's)
SPMM_SWEEP_RHS = (1, 4, 8, 32)  # the other R of the k-major SpMM bins
WL_SWEEP_RHS = (1, 4, 8, 16, 32)  # the R of the headline's wl SpMM bins
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
# the column panels' join: no TPU kernel; it replaces the TPU package's
# panel loops (every panel's bins adding onto one aliased y)
REDUCE_KERNELS = {
    "panel_reduce": f"{TPU}:1237",
    "panel_reduce_dd": f"{TPU_DD}:739",
}
# the dd entry's x split and y join: no TPU kernel; they replace the XLA
# split and join of the TPU package's fp64 entry, 9 and 3 PyTorch launches
# of the port's
SPLIT_JOIN_KERNELS = {
    "dd_prepare_x": f"{TPU_DD}:786 (x split)",
    "dd_join_y": f"{TPU_DD}:786 (y join)",
}
FEM3D_COLS = 648_000  # fem3d_cube's fem_3d(60, 60, 60, dof=3): rows, cols
# CG's fused kernels: they replace the eager PyTorch ops of the port's CG
# iteration, the TPU package's while_loop body; -> vectors each reads and
# writes (n entries of the state's dtype)
CG_REPLACES = ("sparsematrixvectormultiplication_tpu/solvers/cg.py:64 "
               "(the lax.while_loop body)")
CG_KERNELS = {"cg_init": 5, "cg_alpha": 2, "cg_step": 7, "cg_dir": 4}
# the gather of a split, sorted SELL's y into the caller's rows: no TPU
# kernel; it replaces the host's unpermute and segment sum
ROW_MAP_KERNELS = {
    "row_gather": "sparsematrixvectormultiplication_tpu/formats/sell.py:218 "
                  "(SellMatrix.unpermute, host)",
    "row_gather_dd": "sparsematrixvectormultiplication_tpu/formats/sell.py:"
                     "218 (SellMatrix.unpermute, host)",
}
ROW_MAP_SCALES = (16, 20)  # kron: through sell_spmv; the gather timed alone
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


# the solver phase's SELL matrices and the layouts each conversion must hold
# (its fourth matrix, spd_band, is blocked to 128x128 BSR)
SOLVER_LAYOUTS = {"spd_fem3d": {"wl"}, "cfd_like": {"sb-major", "wl"},
                  "pagerank": {"k-major", "sg"}}
SOLVER_RHS = 16        # cg_multi's right-hand sides
# a dd matvec over the PageRank operator's 37 bins queues some 50 kernels:
# 20 calls behind device_time_fn's spin overflow the stream's launch queue
SOLVER_TIME_REPS = 10
SUBSPACE_K = 8
LANCZOS_M = 30
GMRES_RESTART = 30


class Counted:
    """A matvec or matmat that counts its calls since ``reset``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, v):
        self.calls += 1
        return self.fn(v)

    def reset(self):
        self.calls = 0


class ByLaunches:
    """The matvecs a solver made through its own matvec ``fn``, counted
    from the launches of ``wrapper``, which runs ``per_call`` times a
    matvec."""

    def __init__(self, fn, wrapper, per_call):
        self.fn, self.wrapper, self.per_call = fn, wrapper, per_call
        self.start = wrapper.launches

    @property
    def calls(self):
        return (self.wrapper.launches - self.start) // self.per_call

    def reset(self):
        self.start = self.wrapper.launches


def solver_phase(dev, fem_csr):
    """The solvers of ``solvers/`` at full size over the port's kernels;
    ``fem_csr`` is the CSR of the bench suite's fem3d_cube, ``fem_3d(60,
    60, 60, dof=3, seed=1)``. Returns each kernel's launches in the phase,
    keyed (group, kernel) with group "" (SELL SpMV), " dd", " SpMM" or
    " CG" and " CG f64" (the fused CG kernels' f32 and f64 instantiations,
    which every CG solve but the one with a ``prec`` callable runs)."""
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu_torch import (
        BSRMatrix, COOMatrix, CSRMatrix, SellMatrix)
    from sparsematrixvectormultiplication_tpu_torch import solvers as SV
    from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
        banded, cfd_multidof, webbase_like)
    from sparsematrixvectormultiplication_tpu_torch.ops import bsr as BSR
    from sparsematrixvectormultiplication_tpu_torch.ops import cg_step as CS
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn)

    t_phase = time.perf_counter()
    groups = {"": S._KERNEL, " dd": D._KERNEL_DD,
              " SpMM": {"k-major": SM.k_major_spmm_bin,
                        "wl": SM.wl_spmm_bin, **BSR.ROUTES}}

    def snap():
        return {(g, k): w.launches for g, ws in groups.items()
                for k, w in ws.items()}

    rng = np.random.default_rng(SEED)

    def with_shift(csr, vals):
        """``csr``'s pattern with ``vals`` plus c on every diagonal slot, c
        = the largest absolute row sum + 1: strictly diagonally dominant."""
        rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
        diag = rows == csr.col_idx
        if not np.array_equal(np.bincount(rows[diag], minlength=csr.nrows),
                              np.ones(csr.nrows)):
            fail("solvers: a row lacks its diagonal slot")
        c = np.bincount(rows, weights=np.abs(vals), minlength=csr.nrows).max()
        vals = vals.copy()
        vals[diag] += c + 1.0
        return CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, vals)

    def sell_of(name, csr):
        sell = SellMatrix.from_csr(csr)
        got = {b.layout for b in sell.bins}
        if got != SOLVER_LAYOUTS[name] or sell.row_perm is not None:
            fail(f"solvers {name}: the conversion gave layouts {sorted(got)}"
                 f", the phase exists to run {sorted(SOLVER_LAYOUTS[name])}")
        return sell

    # ---- the matrices, converted on the host ----
    t0 = time.perf_counter()
    # spd_fem3d: (M + M^T)/2 + c I on the symmetric pattern (sorted rows: the
    # transpose has the same row_ptr and col_idx)
    t = fem_csr.transpose()
    if not (np.array_equal(t.row_ptr, fem_csr.row_ptr)
            and np.array_equal(t.col_idx, fem_csr.col_idx)):
        fail("solvers: fem3d's pattern is not symmetric")
    fem = with_shift(fem_csr, (fem_csr.values + t.values) / 2)
    del t
    fem_sell = sell_of("spd_fem3d", fem)
    cfd = CSRMatrix.from_coo(cfd_multidof(180, 180, dof=5, seed=15))
    cfd = with_shift(cfd, cfd.values)
    cfd_sell = sell_of("cfd_like", cfd)
    coo = webbase_like(1_000_000, 3, seed=9)
    web = CSRMatrix.from_coo(COOMatrix(coo.nrows, coo.ncols, coo.row,
                                       coo.col, np.abs(coo.val)))
    op, dangling = SV.pagerank_operator(web)
    web_sell = sell_of("pagerank", op)
    m = CSRMatrix.from_coo(banded(250_000, 64, 64, seed=11)).to_scipy()
    a = (m + m.T) / 2
    band = CSRMatrix.from_scipy(
        a + sp.eye(a.shape[0]) * (abs(a).sum(axis=1).max() + 1.0))
    del m, a
    bsr = BSRMatrix.from_csr(band)
    convert_s = time.perf_counter() - t0
    print(f"[solvers] spd_fem3d {fem.nrows} rows, {fem.nnz} nnz, bins "
          f"{[(b.layout, b.k, b.n_groups) for b in fem_sell.bins]}; cfd_like "
          f"{cfd.nrows} rows, {cfd.nnz} nnz, bins "
          f"{[(b.layout, b.k, b.n_groups) for b in cfd_sell.bins]}; pagerank "
          f"{op.nrows} rows, {op.nnz} nnz, {int(dangling.sum())} dangling, "
          f"{len(web_sell.bins)} bins of "
          f"{sorted({b.layout for b in web_sell.bins})}; spd_band "
          f"{band.nrows} rows, {band.nnz} nnz, BSR kb {bsr.kb}, "
          f"{bsr.blocks.nbytes} B of f32 blocks; conversions "
          f"{convert_s:.1f} s", flush=True)

    t0 = time.perf_counter()
    d_fem = S.device_put_sell(fem_sell, device=dev)
    d_fem_bf = S.device_put_sell(fem_sell, torch.bfloat16, device=dev)
    d_fem_dd = D.device_put_sell_dd(fem_sell, device=dev)
    d_cfd = S.device_put_sell(cfd_sell, device=dev)
    d_cfd_dd = D.device_put_sell_dd(cfd_sell, device=dev)
    d_web = S.device_put_sell(web_sell, device=dev)
    d_web_dd = D.device_put_sell_dd(web_sell, device=dev)
    d_band = BSR.device_put_bsr(bsr, device=dev)
    del fem_sell, cfd_sell, web_sell, bsr
    torch.cuda.synchronize()
    print(f"[solvers] uploads {time.perf_counter() - t0:.1f} s", flush=True)

    def sell_mv(d):
        """``v -> A @ v`` through sell_spmv on one padded x table."""
        tab = torch.zeros(S.slab_table_rows(d.ncols) * 128, device=dev)

        def mv(v):
            tab[: v.shape[0]].copy_(v)
            return S.sell_spmv(d, tab)
        return mv

    def dd_mv(d):
        return lambda v: D.sell_spmv_dd_f64(d, v)

    def vec(n, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)

    def block(n, k):
        return torch.from_numpy(rng.standard_normal((n, k))).to(
            dev, torch.float32)

    def host(t):
        return t.double().cpu().numpy()

    def rel_res(csr, x, b):
        """The true relative residual ``||b - A x|| / ||b||`` on the host,
        fp64, per column of a block."""
        xs, bs = host(x), host(b)
        if xs.ndim == 1:
            return np.linalg.norm(bs - csr.spmv(xs)) / np.linalg.norm(bs)
        r = [np.linalg.norm(bs[:, j] - csr.spmv(xs[:, j]))
             / np.linalg.norm(bs[:, j]) for j in range(xs.shape[1])]
        return max(r)

    def check_res(name, csr, x, b, limit):
        got = rel_res(csr, x, b)
        if not got <= limit:
            fail(f"solvers {name}: true relative residual {got:.3e} > "
                 f"{limit:.0e}")
        return f"true relative residual {got:.3e} (limit {limit:.0e})"

    def run(name, solve, ops, check):
        """Solve once to warm up, then once timed between synchronizations;
        ``ops`` are (counted matvec, an argument of its shape): each one's
        calls in the timed solve and its device time by device_time_fn.
        ``check(out)`` returns (iterations, a note) or fails."""
        solve()
        for op, _ in ops:
            op.reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        calls = [op.calls for op, _ in ops]
        ms = [device_time_fn(op.fn, arg, device=dev,
                             reps=SOLVER_TIME_REPS) * 1e3 for op, arg in ops]
        iters, note = check(out)
        inside = sum(c * t for c, t in zip(calls, ms))
        share = 1.0 - inside / wall
        print(f"[solvers] {name}: {iters} iterations, matvecs {calls}, solve "
              f"{wall:.3f} ms ({wall / max(iters, 1):.4f} ms an iteration), "
              f"one matvec {', '.join(f'{t:.4f}' for t in ms)} ms device, "
              f"outside the matvecs {share:.1%} of the solve; {note}",
              flush=True)
        return out

    # the launch counts of the phase, from 0
    for ws in groups.values():
        for w in ws.values():
            w.launches = 0
            w.accumulating = 0
    for kname in CG_KERNELS:
        getattr(CS, kname).launches = 0

    # ---- spd_fem3d ----
    n = fem.nrows
    mv32 = Counted(sell_mv(d_fem))
    b32 = vec(n)

    def cg_sell_check(out):
        x, k, _ = out
        return k, check_res("cg_sell", fem, x, b32, 1e-4)

    # cg_sell's own matvec, counted by the wl kernel's launches
    run("spd_fem3d cg_sell f32", lambda: SV.cg_sell(d_fem, b32, tol=1e-5),
        [(ByLaunches(mv32.fn, S.wl_bin, len(d_fem.bins)), b32)],
        cg_sell_check)

    minv = SV.jacobi_preconditioner(fem, torch.float32, device=dev)
    run("spd_fem3d pcg jacobi f32",
        lambda: SV.cg(mv32, b32, tol=1e-5, minv=minv), [(mv32, b32)],
        lambda out: (out[1], check_res("pcg jacobi", fem, out[0], b32,
                                       1e-4)))
    lmin, lmax = SV.lanczos_bounds(mv32.fn, n, m=LANCZOS_M, device=dev)
    prec = SV.chebyshev_preconditioner(mv32, lmin, lmax, degree=4)
    run("spd_fem3d pcg chebyshev(4) f32",
        lambda: SV.cg(mv32, b32, tol=1e-5, prec=prec), [(mv32, b32)],
        lambda out: (out[1], check_res("pcg chebyshev", fem, out[0], b32,
                                       1e-4) + f"; Lanczos bounds "
                     f"[{lmin:.4f}, {lmax:.4f}]"))
    mvdd = Counted(dd_mv(d_fem_dd))
    b64 = vec(n, torch.float64)
    cg_before = {k: getattr(CS, k).launches for k in CG_KERNELS}
    run("spd_fem3d cg dd", lambda: SV.cg(mvdd, b64, tol=1e-10),
        [(mvdd, b64)],
        lambda out: (out[1], check_res("cg dd", fem, out[0], b64, 1e-9)))
    # the f64 instantiations' launches: this phase's one fp64-state solve
    cg_f64 = {k: getattr(CS, k).launches - n for k, n in cg_before.items()}
    mvbf = Counted(sell_mv(d_fem_bf))
    b_ref = rng.standard_normal(n)

    def refine():
        return SV.iterative_refinement(
            lambda r: SV.cg(mvbf, torch.from_numpy(r).to(dev, torch.float32),
                            tol=1e-2, maxiter=50)[0].cpu().numpy(),
            lambda x: mvdd(torch.from_numpy(x).to(dev)).cpu().numpy(),
            b_ref, tol=1e-12)

    def refine_check(out):
        x, sweeps, resnorms = out
        got = np.linalg.norm(b_ref - fem.spmv(x)) / np.linalg.norm(b_ref)
        if not got <= 1e-12:
            fail(f"solvers refinement: true relative residual {got:.3e} > "
                 f"1e-12 ({resnorms})")
        return sweeps, (f"true relative residual {got:.3e} (limit 1e-12), "
                        f"dd residuals {[f'{r:.1e}' for r in resnorms]}")

    bf_before = S.wl_bin.launches
    run("spd_fem3d refinement (bf16 cg inner, dd residual)", refine,
        [(mvbf, b32), (mvdd, b64)], refine_check)
    bf16_wl = S.wl_bin.launches - bf_before

    mm = Counted(lambda X: SM.sell_spmm(d_fem, X))
    B = block(n, SOLVER_RHS)
    run(f"spd_fem3d cg_multi sell_spmm R={SOLVER_RHS}",
        lambda: SV.cg_multi(mm, B, tol=1e-5), [(mm, B)],
        lambda out: (out[1], check_res("cg_multi sell_spmm", fem, out[0], B,
                                       1e-4) + " (worst column)"))
    Q0 = block(n, SUBSPACE_K)

    def subspace_check(out):
        w, Q, it, res = out
        Qh = host(Q)
        AQ = fem.to_scipy() @ Qh
        H = Qh.T @ AQ
        H = 0.5 * (H + H.T)
        wh = np.linalg.eigvalsh(H)
        wh = wh[np.argsort(-np.abs(wh))]
        err = np.abs(host(w) - wh).max() / np.abs(wh).max()
        res_h = np.linalg.norm(AQ - Qh @ H) / np.linalg.norm(AQ)
        if not err <= 1e-4 or not abs(float(res) - res_h) <= 1e-3 * max(
                res_h, 1e-3):
            fail(f"solvers subspace: Ritz values {err:.3e} from the host's "
                 f"(limit 1e-4), block residual {float(res):.4e} against "
                 f"the host's {res_h:.4e}")
        return it, (f"Ritz values {np.round(wh, 4).tolist()}, within "
                    f"{err:.1e} of the host's; block residual "
                    f"{float(res):.4e} (host {res_h:.4e})")

    run(f"spd_fem3d subspace k={SUBSPACE_K} sell_spmm",
        lambda: SV.subspace_iteration(mm, Q0, maxiter=50), [(mm, Q0)],
        subspace_check)
    v0 = vec(n)

    def power_check(out):
        lam, v, k = out
        vh = host(v)
        rq = vh @ fem.spmv(vh) / (vh @ vh)
        if not abs(rq - float(lam)) <= 1e-5 * abs(rq):
            fail(f"solvers power_iteration: lambda {float(lam)} against the "
                 f"host Rayleigh quotient {rq}")
        return k, f"lambda {float(lam):.6f}, host Rayleigh quotient {rq:.6f}"

    run("spd_fem3d power_iteration f32",
        lambda: SV.power_iteration(mv32, v0), [(mv32, v0)], power_check)
    rows = np.repeat(np.arange(n), np.diff(fem.row_ptr))
    diag = np.zeros(n)
    diag[rows[rows == fem.col_idx]] = fem.values[rows == fem.col_idx]
    radius = np.bincount(rows, weights=np.abs(fem.values), minlength=n) \
        - np.abs(diag)
    g_lo, g_hi = float((diag - radius).min()), float((diag + radius).max())

    def lanczos_check(out):
        alphas, betas, V = out
        Vh = host(V)
        orth = np.linalg.norm(Vh @ Vh.T - np.eye(LANCZOS_M))
        if not orth < 1e-4:
            fail(f"solvers lanczos: ||V V^T - I|| = {orth:.3e}")
        return LANCZOS_M, f"||V V^T - I|| {orth:.3e} (limit 1e-4)"

    run(f"spd_fem3d lanczos m={LANCZOS_M} f32",
        lambda: SV.lanczos(mv32, v0, m=LANCZOS_M), [(mv32, v0)],
        lanczos_check)

    def extremal_check(out):
        lo, hi = out
        if not g_lo <= lo <= hi <= g_hi:
            fail(f"solvers lanczos_extremal: Ritz values [{lo}, {hi}] not "
                 f"inside the Gershgorin interval [{g_lo}, {g_hi}]")
        return LANCZOS_M, (f"Ritz values [{lo:.4f}, {hi:.4f}] inside the "
                           f"Gershgorin interval [{g_lo:.4f}, {g_hi:.4f}]")

    run(f"spd_fem3d lanczos_extremal m={LANCZOS_M} f32",
        lambda: SV.lanczos_extremal(mv32, v0, m=LANCZOS_M), [(mv32, v0)],
        extremal_check)
    del d_fem, d_fem_bf, d_fem_dd

    # ---- cfd_like (nonsymmetric) ----
    n = cfd.nrows
    mv32 = Counted(sell_mv(d_cfd))
    mvdd = Counted(dd_mv(d_cfd_dd))
    b32, b64 = vec(n), vec(n, torch.float64)
    run("cfd_like bicgstab f32", lambda: SV.bicgstab(mv32, b32, tol=1e-5),
        [(mv32, b32)],
        lambda out: (out[1], check_res("bicgstab", cfd, out[0], b32, 1e-4)))
    run(f"cfd_like gmres({GMRES_RESTART}) f32",
        lambda: SV.gmres(mv32, b32, tol=1e-5, restart=GMRES_RESTART),
        [(mv32, b32)],
        lambda out: (out[1], check_res("gmres f32", cfd, out[0], b32, 1e-4)))
    run(f"cfd_like gmres({GMRES_RESTART}) dd",
        lambda: SV.gmres(mvdd, b64, tol=1e-10, restart=GMRES_RESTART),
        [(mvdd, b64)],
        lambda out: (out[1], check_res("gmres dd", cfd, out[0], b64, 1e-9)))
    del d_cfd, d_cfd_dd

    # ---- pagerank over webbase_like ----
    ref = np.full(op.nrows, 1.0 / op.nrows)
    for _ in range(1000):  # the same iteration in fp64 on the host
        q = 0.85 * (op.spmv(ref) + ref[dangling].sum() / op.nrows) \
            + 0.15 / op.nrows
        moved, ref = np.abs(q - ref).sum(), q
        if moved <= 1e-14:
            break

    def pagerank_check(tag, limit):
        def check(out):
            p, k, _ = out
            ph = host(p)
            l1, mass = np.abs(ph - ref).sum(), abs(ph.sum() - 1.0)
            if not (l1 < limit and mass < limit):
                fail(f"solvers pagerank {tag}: L1 {l1:.3e} from the host's, "
                     f"|sum - 1| {mass:.3e} (limit {limit:.0e})")
            return k, f"L1 {l1:.3e} from the host's, |sum - 1| {mass:.1e}"
        return check

    mv32 = Counted(sell_mv(d_web))
    mvdd = Counted(dd_mv(d_web_dd))
    dang = torch.from_numpy(dangling).to(dev)
    run("pagerank f32", lambda: SV.pagerank(mv32, dang, tol=1e-6),
        [(mv32, vec(op.nrows))], pagerank_check("f32", 1e-5))
    run("pagerank dd", lambda: SV.pagerank(mvdd, dang.double(), tol=1e-10),
        [(mvdd, vec(op.nrows, torch.float64))], pagerank_check("dd", 1e-9))
    del d_web, d_web_dd

    # ---- spd_band: cg_multi over the BSR blockspec kernel ----
    mm = Counted(lambda X: BSR.bsr_spmm(d_band, X))
    B = block(band.nrows, SOLVER_RHS)
    run(f"spd_band cg_multi bsr_spmm R={SOLVER_RHS}",
        lambda: SV.cg_multi(mm, B, tol=1e-5), [(mm, B)],
        lambda out: (out[1], check_res("cg_multi bsr_spmm", band, out[0], B,
                                       1e-4) + " (worst column)"))
    del d_band
    torch.cuda.empty_cache()

    got = snap()
    want = [("", "wl"), (" dd", "wl"), (" SpMM", "wl"),
            (" SpMM", "blockspec")]
    want += [(g, lay) for name in ("cfd_like", "pagerank")
             for lay in SOLVER_LAYOUTS[name] for g in ("", " dd")]
    idle = sorted({f"{lay}{g}" for g, lay in want if got[g, lay] <= 0})
    if idle or bf16_wl <= 0:
        fail(f"solvers: kernels {idle} (wl bf16: {bf16_wl} launches) were not "
             "launched")
    for kname in CG_KERNELS:
        got[" CG f64", kname] = cg_f64[kname]
        got[" CG", kname] = getattr(CS, kname).launches - cg_f64[kname]
        if min(got[" CG", kname], got[" CG f64", kname]) <= 0:
            fail(f"solvers: CG's {kname} kernel was not launched in f32 and "
                 "f64")
    launched = {f"{k}{g}": n for (g, k), n in got.items() if n}
    print(f"[solvers] launches {launched}, of which wl bf16 {bf16_wl}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return got


# the sweep phase: bench.cli.main in-process on suite entries at full size
SWEEP_A = ("kkt_like", "cfd_like")   # call A: --autotune --ladder-sweep
SWEEP_B = (*SWEEP_A, "amazon_like")  # call B: --resume --profile-dir
SWEEP_KERNELS = "serial_hll,csr,ell,sell,sell_bf16,sell_dd,hll"
SWEEP_LAYOUTS = ("k-major", "wl", "sb-major", "sb-list", "sg")


def sweep_phase(dev):
    """The sweep and tune layer at full size: ``bench.cli.main`` on the
    bench suite's kkt_like and cfd_like with ``--autotune --ladder-sweep``
    (call A), then on those two and amazon_like with ``--resume
    --profile-dir`` (call B), into one temporary output directory. Fails
    unless both exit 0, every CSV header is the reference schema's, every
    stage and ladder row has ``significant_diffs == 0``, every ``sell_dd``
    stage a norm-scaled error below ``DD_TOL``, every SELL the stages, the
    ladder sweep and the tuner run agrees with its plain version (f32:
    ``RTOL``/``ATOL_REL``; dd: ``DD_TOL``), the tuner measured or refused
    by a guard each default candidate, call B skipped the two checkpointed
    matrices and ran amazon_like, and the k-major, wl, sb-major, sb-list
    and sg kernels and the dd kernels of every layout the ``sell_dd`` stages
    ran were launched (by the stages or the tuner). Prints each tuner table,
    pick and assembly, the ladder rows, ``report.best_table``, the tuner's
    launches and the number of CUDA kernel events in amazon_like's trace
    (reported only). Returns the launches of the stages and the ladder
    sweep, not the tuner's timing, keyed (group, layout) with group ""
    (SELL SpMV) or " dd"."""
    import csv

    from sparsematrixvectormultiplication_tpu_torch.bench import cli
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        csv_report as R)
    from sparsematrixvectormultiplication_tpu_torch.bench import harness as H
    from sparsematrixvectormultiplication_tpu_torch.bench import report
    from sparsematrixvectormultiplication_tpu_torch.bench import scale as SC
    from sparsematrixvectormultiplication_tpu_torch.ops.doubledouble import (
        combine_f64)
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
    from sparsematrixvectormultiplication_tpu_torch.tune import (
        autotune as T)
    from sparsematrixvectormultiplication_tpu_torch.utils.profiling import (
        TRACE_FILE)

    t_phase = time.perf_counter()
    groups = {"": S._KERNEL, " dd": D._KERNEL_DD}
    for ws in groups.values():
        for w in ws.values():
            w.launches = 0
            w.accumulating = 0
    lines = []

    def counts():
        return {(g, k): (w.launches, w.accumulating)
                for g, ws in groups.items() for k, w in ws.items()}

    def restore(saved):
        for (g, k), (n, acc) in saved.items():
            groups[g][k].launches, groups[g][k].accumulating = n, acc

    # every SELL the sweep runs is held against its plain version at its
    # first call (outside the timed reps): the stages' and the ladder
    # sweep's SpMVs on their own first call, each tuner candidate by one
    # extra call whose launches are taken back off the counters
    held = {"f32": 0.0, "dd": 0.0, "n": 0}

    def first_call(d, key):
        done = d.__dict__.setdefault("_held_to_plain", set())
        new = key not in done
        done.add(key)
        return new

    def spmv_held(d, xt, assembly="auto"):
        y = S.sell_spmv(d, xt, assembly)
        if first_call(d, assembly):
            y_p = S.sell_spmv_plain(d, xt, assembly)
            scale = y_p.abs().max().item()
            if not torch.allclose(y, y_p, rtol=RTOL, atol=ATOL_REL * scale):
                fail(f"sweep: a SELL ({len(d.bins)} bins, assembly "
                     f"{assembly}) disagrees with its plain version, "
                     f"max|k-p| = {(y - y_p).abs().max().item()}")
            held["f32"] = max(held["f32"], (y - y_p).abs().max().item()
                              / (scale or 1.0))
            held["n"] += 1
        return y

    def spmv_dd_held(d, xh, xl):
        y = D.sell_spmv_dd(d, xh, xl)
        if first_call(d, "dd"):
            y_k = combine_f64(*y)
            y_p = combine_f64(*D.sell_spmv_dd_plain(d, xh, xl))
            scale = y_p.abs().max().item()
            e = (y_k - y_p).abs().max().item()
            if not e <= DD_TOL * scale:
                fail(f"sweep: a dd SELL ({len(d.bins)} bins) disagrees with "
                     f"its plain version, max|k-p| = {e}")
            held["dd"] = max(held["dd"], e / (scale or 1.0))
            held["n"] += 1
        return y

    tuner = {}  # the tuner's timing launches, kept out of the JSON's
    tuner_seconds = T._device_seconds

    def tuner_seconds_held(dsell, xt, device, reps, assembly="auto"):
        saved = counts()
        spmv_held(dsell, xt, assembly)
        restore(saved)
        sec = tuner_seconds(dsell, xt, device, reps, assembly)
        for key, (n, _) in counts().items():
            tuner[key] = tuner.get(key, 0) + n - saved[key][0]
        return sec

    patches = [(H, "sell_spmv", spmv_held), (H, "sell_spmv_dd", spmv_dd_held),
               (SC, "sell_spmv", spmv_held),
               (T, "_device_seconds", tuner_seconds_held)]
    originals = [(m, a, getattr(m, a)) for m, a, _ in patches]

    def log(m):
        lines.append(str(m))
        print(m, flush=True)

    def rows(path):
        with open(path, newline="") as f:
            return list(csv.reader(f))

    tmp = tempfile.mkdtemp(prefix="sweep_")
    base = ["--kernels", SWEEP_KERNELS, "--output-dir", tmp]
    args_a = [a for m in SWEEP_A for a in ("--suite-entry", m)]
    args_b = [a for m in SWEEP_B for a in ("--suite-entry", m)]
    for m, a, f in patches:
        setattr(m, a, f)
    try:
        t0 = time.perf_counter()
        rc = cli.main(args_a + base + ["--autotune", "--ladder-sweep"],
                      log=log)
        wall_a = time.perf_counter() - t0
        if rc != 0:
            fail(f"sweep call A exited {rc}")
        native = os.path.join(tmp, "spmv_results.csv")
        per_matrix = {}
        for r in rows(native)[1:]:
            per_matrix[r[0]] = per_matrix.get(r[0], 0) + 1
        n_a = len(lines)
        t0 = time.perf_counter()
        rc = cli.main(args_b + base + ["--resume", "--profile-dir",
                                       os.path.join(tmp, "trace")], log=log)
        wall_b = time.perf_counter() - t0
        if rc != 0:
            fail(f"sweep call B exited {rc}")
    finally:
        for m, a, f in originals:
            setattr(m, a, f)
    for m in SWEEP_A:
        if f"[{m}] skipped (checkpoint)" not in lines[n_a:]:
            fail(f"sweep call B did not skip the checkpointed {m}")
    again = {}
    for r in rows(native)[1:]:
        again[r[0]] = again.get(r[0], 0) + 1
    if ({m: again.get(m) for m in SWEEP_A} != {m: per_matrix.get(m)
                                               for m in SWEEP_A}
            or not again.get("amazon_like")):
        fail(f"sweep: stage rows per matrix {per_matrix} after call A, "
             f"{again} after call B: a checkpointed matrix ran again or "
             "amazon_like did not run")

    headers = {"spmv_results.csv": R.NATIVE_HEADER,
               "spmv_scale_ladders.csv": R.NATIVE_HEADER,
               "spmv_results_openmp.csv": R.OPENMP_HEADER,
               "spmv_results_cuda.csv": R.CUDA_HEADER,
               "spmv_tile_config.csv": R.TILE_HEADER,
               "matrix_memory_stats.csv": R.MEMORY_STATS_HEADER}
    for name, header in headers.items():
        got = rows(os.path.join(tmp, name))
        if got[0] != header:
            fail(f"sweep: {name} has header {got[0]}, not the reference "
                 "schema's")
        if header is R.NATIVE_HEADER:
            col = header.index
            for r in got[1:]:
                if r[col("significant_diffs")] != "0":
                    fail(f"sweep {name}: {r[0]} {r[col('stage')]} has "
                         f"{r[col('significant_diffs')]} significant diffs")

    # the dd stages to the oracle as in the other phases: the norm-scaled
    # error of each sell_dd line below DD_TOL
    dd_err = {}
    for ln in lines:
        m = re.match(r"\[(\w+)\] sell_dd: .* norm_err=(\S+)$", ln)
        if m:
            dd_err[m.group(1)] = float(m.group(2))
    if sorted(dd_err) != sorted(SWEEP_B) or not all(
            e < DD_TOL for e in dd_err.values()):
        fail(f"sweep: sell_dd norm-scaled errors {dd_err}: each of "
             f"{list(SWEEP_B)} must be below {DD_TOL}")

    # the tuner's table: every default candidate measured or refused by a
    # guard (its log lines follow the matrix's load line)
    names = [c.name for c in T._default_candidates()]
    matrix, seen = None, {}
    for ln in lines[:n_a]:
        m = re.match(r"\[(\w+)\] load/generate", ln)
        if m:
            matrix = m.group(1)
        m = re.match(r"\[tune\] ([\w-]+)(:| skipped| refused)", ln)
        if m and m.group(1) in names:
            seen.setdefault(matrix, {})[m.group(1)] = ln
    for m in SWEEP_A:
        tab = seen.get(m, {})
        if list(tab) != names or not all(
                "ms measured" in ln
                or re.match(r"\[tune\] [\w-]+ (skipped|refused)", ln)
                for ln in tab.values()):
            fail(f"sweep {m}: the tuner's table {list(tab)} is not the "
                 f"{len(names)} default candidates, each measured or refused")
        ms = {n: float(ln.split(": ")[1].split(" ms")[0])
              for n, ln in tab.items() if "ms measured" in ln}
        pick = next(ln for ln in lines[:n_a]
                    if ln.startswith(f"[{m}] autotune:"))
        ladder = pick.split("ladder=")[1].split()[0]
        print(f"[sweep] {m} tuner: {len(ms)} of {len(names)} candidates "
              f"measured; {pick.split('autotune: ')[1]}; pick "
              f"{ms.get(ladder, float('nan')):.4f} ms against layout='auto' "
              f"(the default ladder) {ms.get('default', float('nan')):.4f} "
              f"ms: x{ms.get('default', float('nan')) / ms.get(ladder, float('nan')):.3f}",
              flush=True)

    # the dd kernels of every layout the sell_dd stages ran (the sell
    # stage's bins: sell_dd runs the same SELL)
    tiles = rows(os.path.join(tmp, "spmv_tile_config.csv"))
    dd_layouts = {r[4] for r in tiles[1:] if r[2] == "sell"}
    total = {(g, k): w.launches for g, ws in groups.items()
             for k, w in ws.items()}
    got = {key: n - tuner.get(key, 0) for key, n in total.items()}
    want = [("", lay) for lay in SWEEP_LAYOUTS]
    want += [(" dd", lay) for lay in sorted(dd_layouts)]
    idle = sorted(f"{lay}{g}" for g, lay in want if total[g, lay] <= 0)
    if idle:
        fail(f"sweep: kernels {idle} were not launched")

    print("[sweep] ladder rows (stage, time_s, padding, bytes/nnz, "
          "%copy rate):", flush=True)
    for r in rows(os.path.join(tmp, "spmv_scale_ladders.csv"))[1:]:
        print(f"[sweep]   {r[0]} {r[4]} {r[7]} s, pad {r[14]}, {r[15]} B, "
              f"{r[16]}%", flush=True)
    print("[sweep] sell stages (time_s, GFLOPS, bytes/nnz, %copy rate): "
          + "; ".join(f"{r[0]} {r[4]} {r[7]} s {r[8]} GF {r[15]} B {r[16]}%"
                      for r in rows(native)[1:]
                      if r[4].startswith("sell")), flush=True)
    print(report.best_table([tmp]), flush=True)
    trace = os.path.join(tmp, "trace", "amazon_like", TRACE_FILE)
    if not os.path.exists(trace):
        fail(f"sweep: call B wrote no trace at {trace}")
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[sweep] amazon_like trace: {len(events)} events, {kernels} CUDA "
          f"kernel events (reported only)", flush=True)
    launched = {f"{k}{g}": n for (g, k), n in got.items() if n}
    timing = {f"{k}{g}": n for (g, k), n in tuner.items() if n}
    print(f"[sweep] {held['n']} SELLs held to their plain versions: max "
          f"|k-p| / max|p| f32 {held['f32']:.3e}, dd {held['dd']:.3e}; "
          f"sell_dd norm-scaled errors {dd_err}", flush=True)
    print(f"[sweep] launches of the stages and the ladder sweep {launched}; "
          f"of the tuner's timing (not in the JSON) {timing}; dd layouts of "
          f"the sell_dd stages {sorted(dd_layouts)}; call A {wall_a:.1f} s, "
          f"call B {wall_b:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    shutil.rmtree(tmp)
    return got


MD_RANKS = 4       # gloo ranks that share cuda:0
MD_TOL = 1e-5      # max|y_sharded - y_single| / max|y_single| (per column)
MD_REPS = 5        # timed calls per measurement of a rank
MD_RHS = 16        # sell_spmm_spmd's right-hand sides on the headline
MD_BSR_RHS = 128   # bsr_spmm_spmd's on band64_250k
MD_SCALE_ENTRY = "cfd_like"


def multidevice_phase(dev, mats):
    """The multi-device layer of ``parallel/`` at full size. ``mats`` maps
    the phases' names to ``(host SELL, x, csr)`` (the SELL that phase's
    ``sell`` stage ran, of the heavy-row-split CSR where the harness split
    it) and ``"band64_250k"`` to its ``(bsr, csr)``.

    Four gloo ranks share ``cuda:0`` (``parallel.launch.spawn``; the parent
    has built the kernels and routers, every rank only loads them), each
    handed only its own host shard, built here once: the headline's held
    SELL sliced into 4 row shards (``sell_spmv_spmd`` and ``sell_spmm_spmd``
    at R=16, wl), banded_adversarial's (sb-major; each rank's kernels also
    held against their plain versions), its 4 column shards
    (``sell_spmv_spmd_cols``, k-major) and its ELL rectangle row-, 2x2- and
    column-sharded (``sharding.py``), scattered_uniform's (sg and
    accumulating k-major bins), webbase_like's PR panels (``pr_spmv_spmd``),
    road's locality split (``split_spmv_spmd``) and band64_250k's block-rows
    (``bsr_spmm_spmd``, B=128). Then banded_adversarial in 4 SELL shards on
    ``[cuda:0] * 4`` from this process (``shard_sell_rows``), the row-sharded
    SELL on ``torch.cuda.device_count()`` NCCL ranks, and ``python -m
    ...bench.cli --suite-entry cfd_like --scale-sweep`` at that count.

    Every path must return the same y on every rank, no significant
    difference from the fp64 oracle, and ``max|y - y_single| /
    max|y_single|`` at most ``MD_TOL`` against the same matrix's
    single-device kernels in this run (SpMM: per column); every path that
    runs kernels must launch those of its layouts. Prints per path each
    rank's kernel device time (the ranks in turn), the collective's time,
    the slowest rank's call and the wall of one call, the partition's
    imbalance and the bytes each rank holds: correctness runs of 4 ranks
    on one card, not a scaling curve. Returns the launches of the ranks
    and of this process, keyed (group, kernel) with group "" (SELL SpMV),
    " SpMM" or " PR"."""
    import csv

    from sparsematrixvectormultiplication_tpu_torch.bench import scale as SC
    from sparsematrixvectormultiplication_tpu_torch.formats.hll import (
        HLLMatrix)
    from sparsematrixvectormultiplication_tpu_torch.ops import bsr as BSR
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_spmm as SM
    from sparsematrixvectormultiplication_tpu_torch.parallel import (
        launch, multidevice, spmd_bsr, spmd_colsell, spmd_pallas, spmd_pr,
        spmd_split)
    from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
        difference_metrics, sampled_spmm_metrics)

    t_phase = time.perf_counter()
    n = MD_RANKS

    def natural(y, row_perm, seg, nrows):
        """A y over a SELL's (or PR build's) rows in natural row order: the
        sigma order undone, heavy-row segments summed."""
        y = np.asarray(y, np.float64)
        if row_perm is not None:
            z = np.empty(len(row_perm))
            z[row_perm] = y[: len(row_perm)]
            y = z
        if seg is not None:
            y = np.bincount(np.asarray(seg), weights=y[: len(seg)],
                            minlength=nrows)[:nrows]
        return y[:nrows]

    def single_spmv(sell, x, seg, nrows):
        d = S.device_put_sell(sell, device=dev)
        y = S.sell_spmv(d, S.device_put_x(x, sell.ncols, device=dev))
        return natural(y.cpu().numpy(), sell.row_perm, seg, nrows)

    def segments(csr):
        """The harness's heavy-row split of ``csr``: ``(csr_k, seg)``."""
        med = float(np.median(csr.row_nnz())) if csr.nrows else 0.0
        cap = 16 if med <= 24 else 256
        return csr.split_heavy_rows(cap, strided=cap < 256)

    t0 = time.perf_counter()
    cases = []   # (tag, ShardJob, post, oracle, single, loads, want)

    def add(tag, job, post, oracle, single, want, loads=None):
        cases.append((tag, job, post, oracle, single,
                      loads or SC.shard_loads(job.obj), want))

    def spmv_case(tag, path, obj, x, csr, single, want, seg=None,
                  mesh=((n,), ("rows",)), loads=None, **kw):
        y_ref = csr.spmv(x)
        add(tag, SC.ShardJob(path, obj, x, *mesh, reps=MD_REPS, detail=True,
                             **kw),
            lambda y: natural(y, None, seg, csr.nrows),
            lambda y: difference_metrics(y_ref, y), single, want, loads)

    # headline: the held wl SELL, sliced, SpMV and SpMM on one host build
    h_sell, h_x, h_csr = mats["headline"]
    h_spmd = spmd_pallas._spmd_from_sell(h_sell, h_csr, n)
    h_single = single_spmv(h_sell, h_x, None, h_csr.nrows)
    spmv_case("headline sell_spmv_spmd", "sell", h_spmd, h_x, h_csr,
              h_single, {("sell", "wl")})
    X = np.random.default_rng(SEED).standard_normal(
        (h_csr.ncols, MD_RHS), dtype=np.float32)
    d = S.device_put_sell(h_sell, device=dev)
    Y_single = SM.sell_spmm(d, SM.device_put_x_multi(
        X, h_csr.ncols, device=dev)).double().cpu().numpy()
    del d
    add("headline sell_spmm_spmd R=16",
        SC.ShardJob("sell_spmm", h_spmd, X, (n,), reps=MD_REPS, detail=True),
        lambda Y: np.asarray(Y, np.float64),
        lambda Y: sampled_spmm_metrics(h_csr, X, Y), Y_single,
        {("spmm", "wl")})

    # banded_adversarial: rows (sb-major), columns, the ELL paths
    b_sell, b_x, b_csr = mats["banded_adversarial"]
    b_single = single_spmv(b_sell, b_x, None, b_csr.nrows)
    b_spmd = spmd_pallas._spmd_from_sell(b_sell, b_csr, n)
    spmv_case("banded_adversarial sell_spmv_spmd", "sell", b_spmd, b_x,
              b_csr, b_single, {("sell", "sb-major")}, check_plain=True)
    spmv_case("banded_adversarial sell_spmv_spmd_cols", "sell_cols",
              spmd_colsell.build_spmd_sell_cols(b_csr, n), b_x, b_csr,
              b_single, {("sell", "k-major")}, mesh=((n,), ("cols",)))
    hll = HLLMatrix.from_csr(b_csr)
    rows_of = b_csr.row_ids().astype(np.int64)
    rect = hll.num_blocks * hll.hack_size

    def ell_loads(nr, nc):
        """Entries per (row shard, column shard) of the ELL paths."""
        per_r, per_c = -(-rect // nr), -(-b_csr.ncols // nc)
        part = (rows_of // per_r) * nc + np.minimum(
            b_csr.col_idx.astype(np.int64) // per_c, nc - 1)
        return [int(v) for v in np.bincount(part, minlength=nr * nc)]

    for tag, path, mesh, grid in (
            ("row_sharded_spmv", "ell_rows", ((n,), ("rows",)), (n, 1)),
            ("sharded_spmv_2d 2x2", "ell_2d", ((2, 2), ("rows", "cols")),
             (2, 2)),
            ("col_sharded_spmv", "ell_cols", ((n,), ("cols",)), (1, n))):
        spmv_case(f"banded_adversarial {tag}", path, hll, b_x, b_csr,
                  b_single, set(), mesh=mesh, dtype=torch.float32,
                  loads=ell_loads(*grid))

    # scattered_uniform: sg and accumulating k-major bins, sliced
    u_sell, u_x, u_csr = mats["scattered_uniform"]
    spmv_case("scattered_uniform sell_spmv_spmd", "sell",
              spmd_pallas._spmd_from_sell(u_sell, u_csr, n), u_x, u_csr,
              single_spmv(u_sell, u_x, None, u_csr.nrows),
              {("sell", "sg"), ("sell accumulating", "k-major")})

    # webbase_like: PR panels of the heavy-row-split CSR
    w_sell, w_x, w_csr = mats["webbase_pr"]
    w_k, w_seg = segments(w_csr)
    spmv_case("webbase_pr pr_spmv_spmd", "pr",
              spmd_pr.build_spmd_pr(w_k, n), w_x, w_csr,
              single_spmv(w_sell, w_x, w_seg, w_csr.nrows), {("pr", "pr")},
              seg=w_seg)

    # road: the locality split of the heavy-row-split CSR
    r_sell, r_x, r_csr = mats["road_scattered"]
    r_k, r_seg = segments(r_csr)
    r_spmd = spmd_split.build_spmd_split(r_k, n)
    spmv_case("road_scattered split_spmv_spmd", "split", r_spmd, r_x, r_csr,
              single_spmv(r_sell, r_x, r_seg, r_csr.nrows),
              {("pr", "pr")} | {("sell", b.layout) for s in r_spmd.near.shards
                                for b in s.bins}, seg=r_seg)

    # band64_250k: block-rows, B=128
    bsr, c64 = mats["band64_250k"]
    X64 = np.random.default_rng(SEED).standard_normal(
        (c64.ncols, MD_BSR_RHS), dtype=np.float32)
    d = BSR.device_put_bsr(bsr, device=dev)
    Y64 = BSR.bsr_spmm(d, BSR.pad_rhs(X64, c64.ncols, device=dev))[
        :, :MD_BSR_RHS].double().cpu().numpy()
    del d
    add("band64_250k bsr_spmm_spmd B=128",
        SC.ShardJob("bsr", spmd_bsr.shard_bsr(bsr, n), X64, (n,),
                    reps=MD_REPS, detail=True),
        lambda Y: np.asarray(Y, np.float64)[:, :MD_BSR_RHS],
        lambda Y: sampled_spmm_metrics(c64, X64, Y), Y64,
        {("bsr", "blockspec")})
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = launch.spawn(
        SC.run_shard_jobs, n, device_type="cuda", timeout_s=600,
        rank_args=[([dataclasses.replace(job, obj=SC.for_rank(job.obj, r))
                     for _, job, *_ in cases],) for r in range(n)])
    ranks_s = time.perf_counter() - t0
    totals = {}

    def check(tag, recs, post, oracle, single, loads, want, ranks_note):
        for rec in recs[1:]:
            if not np.array_equal(rec["y"], recs[0]["y"]):
                fail(f"[multidevice] {tag}: the ranks returned different y")
        y = post(recs[0]["y"])
        dm = oracle(y)
        if dm.significant_diffs:
            fail(f"[multidevice] {tag}: {dm.significant_diffs} significant "
                 "diffs vs the oracle")
        ys, ss = (a.reshape(len(a), -1) for a in (y, single))
        err = max(float(np.abs(ys[:, j] - ss[:, j]).max()
                        / max(np.abs(ss[:, j]).max(), 1e-300))
                  for j in range(ss.shape[1]))
        if not err <= MD_TOL:
            fail(f"[multidevice] {tag}: max|y - y_single| / max|y_single| "
                 f"{err:.3e} > {MD_TOL}")
        launched = {}
        for rec in recs:
            for key, v in rec["launches"].items():
                launched[key] = launched.get(key, 0) + v
                totals[key] = totals.get(key, 0) + v
        idle = sorted(f"{g} {k}" for g, k in want if not launched.get((g, k)))
        if idle:
            fail(f"[multidevice] {tag}: kernels {idle} were not launched")
        for rec in recs:
            if "plain_max_abs_err" in rec and not rec["plain_max_abs_err"] <= \
                    (RTOL + ATOL_REL) * rec["plain_scale"]:
                fail(f"[multidevice] {tag}: a rank's kernels differ from "
                     f"their plain versions by {rec['plain_max_abs_err']}")
        ms = lambda k: [round(r[k] * 1e3, 4) for r in recs]
        plain = ("; each rank's kernels equal to their plain versions "
                 "within f32 rounding, max|k-p| "
                 f"{max(r['plain_max_abs_err'] for r in recs):.2e}"
                 if "plain_max_abs_err" in recs[0] else "")
        imb = max(loads) / max(np.mean(loads), 1e-30)
        print(f"[multidevice] {tag}, {ranks_note}: kernel device ms per rank "
              f"{ms('local_s')}; collective ms {ms('collective_s')}; call "
              f"ms (slowest rank) {max(ms('call_s'))}; wall ms of one call "
              f"{ms('wall_s')}; imbalance {imb:.4f} (entries {loads}); bytes "
              f"per rank {[r['bytes'] for r in recs]}; sig_diffs 0, "
              f"max|y - y_single| / max|y_single| {err:.2e}; launches "
              f"{ {f'{g} {k}': v for (g, k), v in sorted(launched.items())} }"
              f"{plain}", flush=True)

    note = (f"{n} gloo ranks sharing cuda:0 (a correctness run, not a "
            "scaling curve)")
    for j, (tag, job, post, oracle, single, loads, want) in enumerate(cases):
        recs = [o[j] for o in out]
        if {r["backend"] for r in recs} != {"gloo"}:
            fail(f"[multidevice] {tag}: ran on {recs[0]['backend']}, not "
                 "gloo")
        check(tag, recs, post, oracle, single, loads, want, note)

    # one process, four SELL shards on cuda:0; its launches counted from here
    for w in S._KERNEL.values():
        w.launches = 0
        w.accumulating = 0
    t0 = time.perf_counter()
    md = multidevice.shard_sell_rows(b_csr, [dev] * n)
    y = md.spmv(b_x)
    torch.cuda.synchronize()
    walls = []
    for _ in range(MD_REPS):
        t1 = time.perf_counter()
        md.spmv(b_x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    y = y.double().cpu().numpy()
    err = float(np.abs(y - b_single).max() / np.abs(b_single).max())
    sig = difference_metrics(b_csr.spmv(b_x), y).significant_diffs
    if sig or not err <= MD_TOL or y.shape != (b_csr.nrows,):
        fail(f"[multidevice] shard_sell_rows: {sig} significant diffs, "
             f"max|y - y_single| / max|y_single| {err:.3e}")
    md_launches = {("sell", k): w.launches for k, w in S._KERNEL.items()
                   if w.launches}
    if not md_launches.get(("sell", "sb-major")):
        fail("[multidevice] shard_sell_rows: the sb-major kernel was not "
             "launched")
    for key, v in md_launches.items():
        totals[key] = totals.get(key, 0) + v
    loads = [int(s.nnz) for _, s in md.shards]
    print(f"[multidevice] banded_adversarial shard_sell_rows on [cuda:0] * "
          f"{n}, one process: row starts {md.row_starts.tolist()}, "
          f"imbalance {max(loads) / np.mean(loads):.4f}; wall ms of one "
          f"call (host x to y, median of {MD_REPS}) "
          f"{statistics.median(walls) * 1e3:.4f}; sig_diffs 0, max|y - "
          f"y_single| / max|y_single| {err:.2e}; launches {md_launches}; "
          f"conversions and call {time.perf_counter() - t0:.1f} s",
          flush=True)
    del md
    torch.cuda.empty_cache()

    # the NCCL code path: one rank per card
    t0 = time.perf_counter()
    ndev = torch.cuda.device_count()
    spmd = spmd_pallas._spmd_from_sell(b_sell, b_csr, ndev)
    job = SC.ShardJob("sell", spmd, b_x, (ndev,), reps=MD_REPS, detail=True)
    out = launch.spawn(SC.run_shard_jobs, ndev, device_type="cuda",
                       timeout_s=300, rank_args=[(
                           [dataclasses.replace(job, obj=SC.for_rank(spmd, r))],)
                           for r in range(ndev)])
    recs = [o[0] for o in out]
    if {r["backend"] for r in recs} != {"nccl"}:
        fail(f"[multidevice] the NCCL ranks ran on {recs[0]['backend']}")
    y_ref = b_csr.spmv(b_x)
    check("banded_adversarial sell_spmv_spmd", recs,
          lambda y: np.asarray(y, np.float64),
          lambda y: difference_metrics(y_ref, y), b_single,
          SC.shard_loads(spmd), {("sell", "sb-major")},
          f"{ndev} NCCL rank(s), one a card; whole call by device time "
          f"({time.perf_counter() - t0:.1f} s with the spawn)")

    # the device-count sweep through the CLI, at the card's count
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="scale_sweep_")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.bench.cli", "--suite-entry",
         MD_SCALE_ENTRY, "--scale-sweep", "--kernels", "sell",
         "--output-dir", tmp],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        fail(f"[multidevice] bench.cli --scale-sweep exited "
             f"{proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    with open(os.path.join(tmp, "spmv_scale_devices.csv"), newline="") as f:
        rows = list(csv.reader(f))
    shutil.rmtree(tmp)
    counts = [n_ for n_ in (1, 2, 4, 8, 16, 32) if n_ <= ndev]
    col = rows[0].index("num_threads") if rows else 0
    if [r[col] for r in rows[1:]] != [str(c) for c in counts]:
        fail(f"[multidevice] the scale sweep wrote rows {rows[1:]}, not one "
             f"per count {counts}")
    t_col = rows[0].index("time_parallel")
    sweep = [ln for ln in proc.stdout.splitlines() if "spmd_sell x" in ln]
    print(f"[multidevice] bench.cli --suite-entry {MD_SCALE_ENTRY} "
          f"--scale-sweep: {len(rows) - 1} row(s), time_parallel s "
          f"{[r[t_col] for r in rows[1:]]}; {sweep}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[multidevice] host builds {build_s:.1f} s, the gloo ranks "
          f"{ranks_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    group = {"sell": "", "spmm": " SpMM", "bsr": " SpMM", "pr": " PR"}
    return {(group[g], k): v for (g, k), v in totals.items() if g in group}


DRYRUN_RANKS = 4   # dryrun_multichip's gloo ranks sharing cuda:0
# the demo's lines, in its order; those with significant_diffs are its tiers
DEMO_LINES = ("SELL f32:", "SELL fp64dd:", "BSR SpMM (", "SELL bf16:",
              "SELL SpMM (", "refinement (bf16 inner CG):",
              "Chebyshev(4) PCG:", "PageRank:", "auto format:",
              "auto matvec (")


def entry_programs_phase(dev, smi):
    """The entry programs ``entry.py`` and ``demo.py`` through their entry
    points. ``entry.entry()`` on ``dev``: its y equal to the plain version
    of its k-major bin bit for bit and without a significant difference
    from the fp64 oracle, and ``sell_k_major`` launched.
    ``dryrun_multichip(DRYRUN_RANKS)`` (gloo ranks sharing the card) and
    ``dryrun_multichip(torch.cuda.device_count())`` (one NCCL rank a card):
    every path OK on the expected backend (``dryrun_multichip`` raises
    where the ranks' y differ or a path but the ELL ones launched none of
    its kernels), and the 2-D ELL path reported as skipped where the JAX
    dryrun's mesh does not cover the ranks (n = 1). ``python -m ...demo``
    in a subprocess: exit 0, each line of ``DEMO_LINES`` printed, every
    tier ``significant_diffs=0`` and the SELL f32 time beside the card's
    name.
    Returns the launches of ``entry()`` and of the ranks, keyed (group,
    kernel) with group "" (SELL SpMV), " SpMM" or " PR"."""
    from sparsematrixvectormultiplication_tpu_torch.entry import (
        _mesh_2d, dryrun_multichip, entry)
    from sparsematrixvectormultiplication_tpu_torch.formats.csr import (
        CSRMatrix)
    from sparsematrixvectormultiplication_tpu_torch.models.synthetic import (
        banded)
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.parallel.launch import (
        backend_for)
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn)
    from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
        difference_metrics)

    t_phase = time.perf_counter()
    totals = {}

    # entry(): one SpMV step; its launches read before it is timed
    t0 = time.perf_counter()
    fn, (dsell, x) = entry(dev)
    k0 = S._KERNEL["k-major"].launches
    y = fn(dsell, x)
    torch.cuda.synchronize()
    n_entry = S._KERNEL["k-major"].launches - k0
    if not n_entry:
        fail("[entry programs] entry(): sell_k_major was not launched")
    totals["sell", "k-major"] = n_entry
    if not torch.equal(y, S.sell_spmv_plain(dsell, x)):
        fail("[entry programs] entry(): y differs from the plain k-major "
             "version")
    csr = CSRMatrix.from_coo(banded(8192, 24, 512, seed=0))
    dm = difference_metrics(csr.spmv(np.ones(csr.ncols)),
                            y.double().cpu().numpy())
    if dm.significant_diffs or y.shape != (csr.nrows,):
        fail(f"[entry programs] entry(): {dm.significant_diffs} significant "
             f"diffs vs the oracle, y of shape {tuple(y.shape)}")
    ms = device_time_fn(fn, dsell, x, device=dev) * 1e3
    print(f"[entry programs] entry() on {dev}: bins "
          f"{[(b.layout, b.k, b.n_groups) for b in dsell.bins]}, "
          f"sell_k_major launched {n_entry}; y equal to the plain version "
          f"bit for bit; sig_diffs 0, max_rel {dm.max_rel_err:.2e}; device "
          f"{ms:.4f} ms ({smi}); {time.perf_counter() - t0:.1f} s",
          flush=True)
    del dsell, x, y

    for n in (DRYRUN_RANKS, torch.cuda.device_count()):
        t0 = time.perf_counter()
        summary = dryrun_multichip(
            n, "cuda",
            log=lambda m: print(f"[entry programs] {m}", flush=True))
        skip = _mesh_2d(n)[1]
        backend = backend_for("cuda", n)
        for s in summary:
            if s["path"] == "ell_2d" and skip is not None:
                if s["status"] != "skipped":
                    fail(f"[entry programs] dryrun_multichip({n}): the 2-D "
                         "path ran on a mesh that does not cover the ranks")
                continue
            if s["status"] != "ok" or s["backend"] != backend:
                fail(f"[entry programs] dryrun_multichip({n}) "
                     f"{s['function']}: {s['status']} on {s.get('backend')}, "
                     f"not ok on {backend}")
            for key, v in s["launches"].items():
                totals[key] = totals.get(key, 0) + v
        errs = {s["path"]: f"{s['rel_err']:.2e}" for s in summary
                if s["status"] == "ok"}
        print(f"[entry programs] dryrun_multichip({n}): {n} {backend} "
              f"rank(s) on {torch.cuda.device_count()} card(s), "
              f"max|y - y_ref| / max|y_ref| by path {errs}; 2-D "
              f"{'skipped: ' + skip if skip else 'ran'}; "
              f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.demo"], capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.splitlines()
    for ln in lines:
        print(f"[entry programs] demo: {ln}", flush=True)
    if proc.returncode != 0:
        fail(f"[entry programs] the demo exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    timed = f"SELL f32 time on {torch.cuda.get_device_name(0)}:"
    for head in (*DEMO_LINES, timed):
        got = [ln for ln in lines if ln.startswith(head)]
        if len(got) != 1:
            fail(f"[entry programs] the demo printed {len(got)} lines that "
                 f"start with {head!r}")
        if "significant_diffs=" in got[0] and \
                "significant_diffs=0 " not in got[0]:
            fail(f"[entry programs] demo tier: {got[0]}")
    print(f"[entry programs] demo exited 0 in "
          f"{time.perf_counter() - t0:.1f} s ({smi}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    group = {"sell": "", "spmm": " SpMM", "bsr": " SpMM", "pr": " PR"}
    return {(group[g], k): v for (g, k), v in totals.items() if g in group}


# the flagship line's matrices and the main-path phase whose COO each takes
FLAGSHIP_COOS = {"fem3d_cube": "headline",
                 "banded_adversarial": "banded_adversarial",
                 "road_scattered": "road_scattered"}
# the kernels the flagship line must launch, (group, layout): "" f32, " bf16"
# and " dd"
FLAGSHIP_KERNELS = (("", "wl"), (" bf16", "wl"), (" dd", "wl"),
                    ("", "sb-major"), (" dd", "sb-major"), ("", "sb-list"))


def split_join_phase(dev):
    """The dd entry's x split and y join kernels at fem3d_cube's shape
    (648,000 columns and rows; x with signed zeros, subnormals, values
    past f32's range, infinities and NaN): ``dd_prepare_x`` in the pair
    table alone (fem3d_cube's plan) and with the two padded halves, and
    ``dd_join_y``, each bit for bit its plain version (NaN payloads
    aside), which is the PyTorch composition it replaced. Prints each
    one's device time, its bound (bytes), the composition's device time and
    each one's host time a call; returns ``{kernel: (ms, plain_ms,
    bound_ms)}``, the prepare row in fem3d_cube's mode."""
    from sparsematrixvectormultiplication_tpu_torch.formats.sell import (
        slab_table_rows)
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn)

    t_phase = time.perf_counter()
    n = FEM3D_COLS
    rows = slab_table_rows(n) * 128
    rng = np.random.default_rng(SEED)
    special = np.array([0.0, -0.0, 5e-324, -1e-310, 1e-45, 3.5e38, -1e300,
                        np.inf, -np.inf, np.nan, 1 / 3])
    x = rng.standard_normal(n)
    x[: special.size] = special
    x = torch.from_numpy(x).to(dev)
    yh, yl = (torch.from_numpy(v).to(dev) for v in (
        rng.standard_normal(n).astype(np.float32),
        (rng.standard_normal(n) * 2.0**-30).astype(np.float32)))

    def same(got, want, what):
        nan = torch.isnan(want)
        ints = torch.int32 if got.element_size() == 4 else torch.int64
        if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                got.view(ints)[~nan], want.view(ints)[~nan])):
            fail(f"split_join: {what} differs from its plain version")

    def host_us(fn, *args, calls=50, **kw):
        """Host microseconds a call, ``calls`` calls queued (the plain
        versions' 9 launches a call stay within the launch queue)."""
        fn(*args, **kw)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args, **kw)
        t = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        return 1e6 * t / calls

    rows_out = {}
    for what, pair, halves in (("pair table", True, False),
                               ("pair table and halves", True, True)):
        got = D.dd_prepare_x(x, rows, pair=pair, halves=halves)
        want = D.dd_prepare_x_plain(x, rows, pair, halves)
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                fail(f"split_join: dd_prepare_x ({what}) wrote other tables")
            if g is not None:
                same(g.contiguous(), w.contiguous(), f"dd_prepare_x ({what})")
        ms = device_time_fn(lambda: D.dd_prepare_x(
            x, rows, pair=pair, halves=halves), device=dev) * 1e3
        ms_p = device_time_fn(D.dd_prepare_x_plain, x, rows, pair, halves,
                              device=dev) * 1e3
        bound = (8 * n + 8 * rows * (pair + halves)) / HBM_BYTES_PER_S * 1e3
        print(f"[split_join] dd_prepare_x, {what}, {n} columns into "
              f"{rows} rows: device {ms:.4f} ms, bound {bound:.6f} ms; the "
              f"PyTorch composition it replaces (its plain version) "
              f"{ms_p:.4f} ms; host a call "
              f"{host_us(D.dd_prepare_x, x, rows, pair=pair, halves=halves):.1f}"
              f" us against "
              f"{host_us(D.dd_prepare_x_plain, x, rows, pair, halves):.1f} "
              f"us; equal bit for bit", flush=True)
        if (pair, halves) == (True, False):
            rows_out["dd_prepare_x"] = (ms, ms_p, bound)
    same(D.dd_join_y(yh, yl), D.dd_join_y_plain(yh, yl), "dd_join_y")
    ms = device_time_fn(D.dd_join_y, yh, yl, device=dev) * 1e3
    ms_p = device_time_fn(D.dd_join_y_plain, yh, yl, device=dev) * 1e3
    bound = 16 * n / HBM_BYTES_PER_S * 1e3
    print(f"[split_join] dd_join_y, {n} rows: device {ms:.4f} ms, bound "
          f"{bound:.6f} ms; the PyTorch composition it replaces (its plain "
          f"version, combine_f64) {ms_p:.4f} ms; host a call "
          f"{host_us(D.dd_join_y, yh, yl):.1f} us against "
          f"{host_us(D.dd_join_y_plain, yh, yl):.1f} us; equal bit for bit; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    rows_out["dd_join_y"] = (ms, ms_p, bound)
    return rows_out


def cg_step_phase(dev, dtype=torch.float32):
    """CG's fused kernels (``ops/cg_step.py``, ``csrc/cg_step.cu``) at
    fem3d_cube's 648,000 rows, in ``dtype`` (float32, or float64, the state
    of CG over fp64 and dd matvecs) with a Jacobi-like ``minv``: each kernel
    after the state of the kernels before it is copied into a second
    solve's, against its plain version (the eager loop's PyTorch ops) there:
    r and p of ``cg_init`` bit for bit (one rounding each), x and r of
    ``cg_step`` and p of ``cg_dir`` within rounding of max|.| (a fused
    multiply-add), the scalars within 1e-5 (f64: 1e-12) relative (sums in
    another order), the flag equal. Prints each one's device time, its
    bound (the vectors it reads and writes over 3.35 TB/s), the plain
    version's device time, and the host time of an iteration's three
    launches against the plain versions'; returns ``{kernel: (ms, plain_ms,
    bound_ms, max_abs_err)}``."""
    from sparsematrixvectormultiplication_tpu_torch.ops import cg_step as CS
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn)

    t_phase = time.perf_counter()
    n, tag = FEM3D_COLS, {torch.float32: "f32", torch.float64: "f64"}[dtype]
    rtol, rel = (RTOL, 1e-5) if dtype == torch.float32 else (DD_TOL, DD_TOL)
    rng = np.random.default_rng(SEED)

    def vec(lo=None):
        v = rng.uniform(lo, 2.0, n) if lo else rng.standard_normal(n)
        return torch.from_numpy(v).to(dev, dtype)

    b, ax, ap, x0, minv = vec(), vec(), vec(), vec(), vec(0.5)
    wk, wp = (CS.CGWork(b, x0, minv, 1e-5) for _ in range(2))
    s = wp.scalars
    plain = {"cg_init": lambda: CS.cg_init_plain(wp.b, ax, wp.minv, wp.r,
                                                 wp.p, s, wp.tol),
             "cg_alpha": lambda: CS.cg_alpha_plain(wp.p, ap, s),
             "cg_step": lambda: CS.cg_step_plain(wp.x, wp.r, ap, wp.p,
                                                 wp.minv, s),
             "cg_dir": lambda: CS.cg_dir_plain(wp.r, wp.minv, wp.p, s)}
    kernel = {"cg_init": lambda: CS.cg_init(wk, ax),
              "cg_alpha": lambda: CS.cg_alpha(wk, ap),
              "cg_step": lambda: CS.cg_step(wk, ap),
              "cg_dir": lambda: CS.cg_dir(wk)}
    errs = {}

    def sync_plain():
        for name in ("x", "r", "p", "scalars"):
            getattr(wp, name).copy_(getattr(wk, name))

    def check(kname, exact, close, scalars):
        err = 0.0
        for name in exact:
            if not torch.equal(getattr(wk, name), getattr(wp, name)):
                fail(f"cg_step {tag}: {kname} wrote another {name} than its "
                     "plain version")
        for name in close:
            got, want = getattr(wk, name), getattr(wp, name)
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=rtol, atol=rtol * float(
                    want.abs().max())):
                fail(f"cg_step {tag}: {kname}'s {name} beyond rounding of "
                     "its plain version's")
        for i in scalars:
            got, want = float(wk.scalars[i]), float(s[i])
            if not abs(got - want) <= rel * abs(want):
                fail(f"cg_step {tag}: {kname} scalar {i} {got} against the "
                     f"plain version's {want}")
        errs[kname] = err

    for kname, exact, close, scalars in (
            ("cg_init", ("r", "p"), (), (CS.RZ, CS.RR, CS.ATOL2)),
            ("cg_alpha", (), (), (CS.ALPHA,)),
            ("cg_step", (), ("x", "r"), (CS.BETA, CS.RZ, CS.RR)),
            ("cg_dir", (), ("p",), ())):
        sync_plain()
        kernel[kname]()
        flag = plain[kname]()
        check(kname, exact, close, scalars)
        if flag is not None and CS.cg_unconverged(wk) != bool(flag):
            fail(f"cg_step {tag}: {kname}'s flag differs from its plain "
                 "version's")

    def host_us(fns, calls=50):
        """Host microseconds of one pass of ``fns``, ``calls`` passes
        queued."""
        for fn in fns:
            fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            for fn in fns:
                fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        return 1e6 * t / calls

    rows = {}
    es = b.element_size()
    for kname, vectors in CG_KERNELS.items():
        ms = device_time_fn(kernel[kname], device=dev) * 1e3
        ms_p = device_time_fn(plain[kname], device=dev, reps=10) * 1e3
        bound = vectors * es * n / HBM_BYTES_PER_S * 1e3
        rows[kname] = (ms, ms_p, bound, errs[kname])
        print(f"[cg_step] {kname}, {n} rows {tag}: device {ms:.4f} ms, bound "
              f"{bound:.6f} ms ({vectors} vectors); its plain version (the "
              f"eager loop's ops) {ms_p:.4f} ms; max|kernel - plain| "
              f"{errs[kname]:.2e}", flush=True)
    steps = ("cg_alpha", "cg_step", "cg_dir")
    it_k = host_us([kernel[k] for k in steps])
    it_p = host_us([plain[k] for k in steps])
    CS.cg_settle(wk)
    print(f"[cg_step] host an iteration (cg_alpha, cg_step, cg_dir) {tag}: "
          f"{it_k:.1f} us against the plain versions' {it_p:.1f} us; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def row_map_phase(dev):
    """The gather of a split, sorted SELL's y into the caller's row order
    (``csrc/row_map.cu``) on GAP's kron graph. At SCALE 16 the exported
    ``SellMatrix`` converts it by its row-order rule (a row map kept), and
    ``sell_spmv`` and ``sell_spmv_dd_f64`` run through it: each bit for bit
    its plain version, y within rounding of the oracle, its rows with no
    entry +0, one gather launch a call. At SCALE 20 the rule's row map of
    the graph's degrees (rows over ``HEAVY_ROW_CAP`` split, strided, then
    sorted by length, as the conversion does, which SCALE 16 checks against
    the conversion's own map) drives ``row_gather`` and ``row_gather_dd``
    alone: bit for bit their plain versions, their device times, bounds
    (bytes) and the plain versions' times (wall time: they read the map's
    longest row back to the host). Returns ``{kernel: (ms, plain_ms,
    bound_ms)}``."""
    from sparsematrixvectormultiplication_tpu_torch import (COOMatrix,
                                                            CSRMatrix,
                                                            SellMatrix)
    from sparsematrixvectormultiplication_tpu_torch.formats import (
        sell_order as SO)
    from sparsematrixvectormultiplication_tpu_torch.models import (
        kron_pagerank_reference as KR)
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D
    from sparsematrixvectormultiplication_tpu_torch.utils.timing import (
        device_time_fn)
    from sparsematrixvectormultiplication_tpu_torch.utils.validation import (
        difference_metrics)

    t_phase = time.perf_counter()

    def kron_csr(scale):
        n, row, col = KR.kron_graph(scale, 16, SEED, device=dev)
        val, _ = KR.transition(n, row, col, dtype=torch.float32)
        return CSRMatrix.from_coo(COOMatrix(
            n, n, row.to(torch.int32).cpu().numpy(),
            col.to(torch.int32).cpu().numpy(), val.cpu().numpy()))

    def rule_map(csr):
        segs, seg_map = csr.split_heavy_rows(SO.HEAVY_ROW_CAP, strided=True)
        seg_nnz = segs.row_nnz()
        perm = np.argsort(-seg_nnz, kind="stable")
        return SO.row_map(seg_map, perm, seg_nnz, csr.nrows)

    def same(got, want, what):
        ints = torch.int32
        if not torch.equal(got.contiguous().view(ints),
                           want.contiguous().view(ints)):
            fail(f"row_map: {what} differs from its plain version")

    small, big = ROW_MAP_SCALES
    csr = kron_csr(small)
    ruled = SellMatrix.from_csr(csr)
    if ruled.row_map is None:
        fail(f"row_map: kron at SCALE {small} was not split and sorted")
    if not all(np.array_equal(a, b)
               for a, b in zip(rule_map(csr), ruled.row_map)):
        fail("row_map: the rule's map of the degrees is not the "
             "conversion's")
    n = csr.nrows
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(n)).to(
        dev)
    d = S.device_put_sell(ruled, device=dev)
    tab = S.pack_x_table(x.float(), n)
    before = S.row_gather.launches
    y = S.sell_spmv(d, tab)
    torch.cuda.synchronize(dev)
    if S.row_gather.launches != before + 1:
        fail("row_map: sell_spmv did not gather its y once")
    same(y, S.sell_spmv_plain(d, tab), "sell_spmv through the row map")
    empty = torch.from_numpy(csr.row_nnz() == 0).to(dev)
    if y[empty].view(torch.int32).any():
        fail("row_map: a row with no entry is not +0")
    want = csr.spmv(x.cpu().float().double().numpy())
    sig = difference_metrics(want, y.cpu().double().numpy()).significant_diffs
    dd = D.device_put_sell_dd(ruled, device=dev)
    before = S.row_gather_dd.launches
    y64 = D.sell_spmv_dd_f64(dd, x)
    torch.cuda.synchronize(dev)
    want64 = csr.spmv(x.cpu().numpy())
    dd_err = float(np.abs(y64.cpu().numpy() - want64).max()
                   / np.abs(want64).max())
    if sig or not dd_err < DD_TOL or S.row_gather_dd.launches != before + 1:
        fail(f"row_map: kron SCALE {small}: {sig} significant diffs, dd "
             f"norm-scaled error {dd_err:.3e}, row_gather_dd launches "
             f"{S.row_gather_dd.launches - before}")
    print(f"[row_map] kron SCALE {small}: {n} rows, {csr.nnz} nnz, "
          f"{int(ruled.row_map[1].size)} segments, bins "
          f"{[(b.layout, int(b.k), int(b.n_groups)) for b in ruled.bins]}; "
          f"sell_spmv bit for bit its plain version, dd norm-scaled error "
          f"{dd_err:.3e}", flush=True)
    del d, dd, ruled

    csr = kron_csr(big)
    ptr, pos = rule_map(csr)
    rm = S.RowMap(*(torch.from_numpy(a).to(dev) for a in (ptr, pos)),
                  int(pos.max()) + 1)
    m, n = int(pos.size), csr.nrows
    del csr
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    src = torch.randn(rm.src_rows, generator=g, device=dev)
    lo = src * 2.0**-30
    rows_out = {}
    for kname, fn, plain, args, width in (
            ("row_gather", S.row_gather, S.row_gather_plain, (src,), 4),
            ("row_gather_dd", S.row_gather_dd, S.row_gather_dd_plain,
             (src, lo), 8)):
        got, want = fn(*args, rm), plain(*args, rm)
        for g_, w in zip(*(o if isinstance(o, tuple) else (o,)
                           for o in (got, want))):
            same(g_, w, kname)
        ms = device_time_fn(fn, *args, rm, device=dev) * 1e3
        plain(*args, rm)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            plain(*args, rm)
        torch.cuda.synchronize(dev)
        ms_p = (time.perf_counter() - t0) / 3 * 1e3
        # ptr and y a row, pos and src a segment (src once: a segment is
        # one sorted row of the SpMV's y)
        nbytes = 4 * (n + 1) + width * n + (4 + width) * m
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[row_map] {kname}, kron SCALE {big}: {n} rows, {m} "
              f"segments, {nbytes} B: device {ms:.4f} ms, bound "
              f"{bound:.6f} ms; plain version (wall) {ms_p:.4f} ms; equal "
              f"bit for bit", flush=True)
        rows_out[kname] = (ms, ms_p, bound)
    print(f"[row_map] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows_out


def flagship_phase(dev, coos, generate_s):
    """The flagship line (``bench/flagship.py``, ≙ bench.py) at full size:
    its three per-matrix functions on the main path's COOs of ``coos``
    (phase -> COO; no matrix is generated twice; ``generate_s``, phase ->
    the seconds its generation took there), the record built and printed
    as ``python -m ...bench`` prints it, its ``valid`` true. Each function
    raises where its conversion gives other layouts than the line's (wl,
    sb-major, sb-list). The SELL counters are set to 0 just before and read
    just after: the wl kernel must launch in f32, bf16 and dd, sb-major in
    f32 and dd and sb-list in f32. Returns the launches keyed (group,
    layout) with group "" (f32 and bf16) or " dd"."""
    from sparsematrixvectormultiplication_tpu_torch.bench import (
        flagship as F)
    from sparsematrixvectormultiplication_tpu_torch.ops import sell as S
    from sparsematrixvectormultiplication_tpu_torch.ops import sell_dd as D

    t_phase = time.perf_counter()

    def log(m):
        print(f"[flagship] {m}", flush=True)

    ws = {"": S._KERNEL, " dd": D._KERNEL_DD}
    for w in (*S._KERNEL.values(), *D._KERNEL_DD.values()):
        w.launches = 0
        w.accumulating = 0
    for w in S._KERNEL.values():
        w.launches_bf16 = 0
    runners = {"fem3d_cube": F.run_fem3d_cube,
               "banded_adversarial": F.run_banded_adversarial,
               "road_scattered": F.run_road_scattered}
    results, gen = {}, {}
    for name, phase in FLAGSHIP_COOS.items():
        gen[name] = generate_s[phase]
        results[name] = runners[name](coos[phase], dev, log)
    got = {(g, k): w.launches for g in ws for k, w in ws[g].items()}
    bf16 = {k: w.launches_bf16 for k, w in S._KERNEL.items()}
    card, limit = F.card(dev, log)
    rec = F.flagship_record(
        results, device=card, power_limit_w=limit,
        wall_s=time.perf_counter() - t_phase + sum(gen.values()),
        generate_s=gen, log=log)
    print(json.dumps(rec), flush=True)
    if not rec["valid"]:
        fail("flagship: the record is not valid")
    count = {("", k): got["", k] - bf16[k] for k in bf16}
    count |= {(" bf16", k): bf16[k] for k in bf16}
    count |= {(" dd", k): got[" dd", k] for k in D._KERNEL_DD}
    idle = [f"{k}{g}" for g, k in FLAGSHIP_KERNELS if count[g, k] <= 0]
    if idle:
        fail(f"flagship: the kernels {idle} were not launched")
    launched = {f"{k}{g}": n for (g, k), n in count.items() if n}
    log(f"launches {launched}; the line valid; wall {rec['wall_s']:.1f} s "
        "(with the generation in the main path's phases); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return got


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from sparsematrixvectormultiplication_tpu_torch import (
            COOMatrix, CSRMatrix, PanelPRMatrix, PanelSellMatrix, PRMatrix,
            SellMatrix, auto_device_op, run_matrix)
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

    def need_ms(nnz, value_bytes, n_x, n_y, tables, col_bytes=4):
        """The least time of an SpMV piece: ``nnz`` entries of
        ``value_bytes`` plus a ``col_bytes`` column (4 B; wl's compacted
        planes need a 2 B code), ``n_x`` distinct x entries and ``n_y`` y
        rows per x table (``tables``: 2 for dd), over the HBM rate."""
        moved = nnz * (value_bytes + col_bytes) + (n_x + n_y) * 4 * tables
        return moved / HBM_BYTES_PER_S * 1e3

    def spmm_need(nnz, value_bytes, n_x, n_y, rhs, x_bytes=4,
                  flop_rate=F32_FLOP_PER_S, col_bytes=4):
        """``(ms, bound_by)``, the least time of an SpMM piece: ``nnz``
        entries of ``value_bytes`` plus a ``col_bytes`` column, ``n_x``
        distinct x rows of ``rhs`` values of ``x_bytes`` and ``n_y`` f32 y
        rows of ``rhs`` over the HBM rate, or its 2 FLOP per entry and
        right-hand side over ``flop_rate``, whichever is longer."""
        moved = nnz * (value_bytes + col_bytes) + rhs * (n_x * x_bytes
                                                         + n_y * 4)
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
         {"k-major"}, ("sell", "sell_dd", "sell_spmm", "bsr_spmm"),
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

    def plan_launches(tag, d, run, ws, total):
        """Run one SpMV of ``d`` and count its kernel launches on the
        wrappers ``ws``: they must be its launch plan's (a launch a joint
        bin, and panel_reduce for panels); ``total`` is what
        sell_spmv_launches counts, the zero fills, x tables and pair table
        included. Returns the phase line's note."""
        before = sum(w.launches for w in ws)
        run()
        torch.cuda.synchronize()
        n = sum(w.launches for w in ws) - before
        bins = (sum(len(p.bins) for p in d.panels) if hasattr(d, "panels")
                else len(d.bins))
        if n != d.plan.kernels or total < n:
            fail(f"{tag}: {n} kernel launches a SpMV, the plan's "
                 f"{d.plan.kernels}, sell_spmv_launches {total}")
        return (f"launches per SpMV {total} (sell_spmv_launches; {n} kernel "
                f"launches for {bins} bins, as the plan has them)")

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
        """``sell_spmm`` on the headline's own wl SELL at R = 8 and 16, on
        the raw X, which the wl kernels read in place."""
        d = S.device_put_sell(res.sell, device=dev)
        if {b.layout for b in d.bins} != {"wl"} or res.sell.row_perm \
                is not None or res.sell.nrows != res.nrows:
            fail("headline: the SELL for the wl SpMM is not all wl bins in "
                 "the matrix's row order")
        for rhs in HEADLINE_RHS:
            X = np.random.default_rng(SEED).standard_normal(
                (res.ncols, rhs), dtype=np.float32)
            Xd = torch.from_numpy(X).to(dev)
            if SM._x_table(d, Xd) is not Xd:
                fail(f"headline sell_spmm R={rhs}: the raw X is packed")
            Y = SM.sell_spmm(d, Xd)
            dm = check_spmm(f"headline sell_spmm R={rhs}", res.csr, X,
                            Y.cpu().numpy().astype(np.float64))
            print(f"[headline] sell_spmm R={rhs} on the wl SELL, the raw X "
                  f"read in place: sig_diffs "
                  f"0, max_rel {dm.max_rel_err:.2e}", flush=True)
        return d

    def headline_dd_entry(res, x):
        """The fp64 entry ``sell_spmv_dd_f64`` on the headline's dd SELL
        (fem3d_cube's shape, pair bins alone): the x split and y join
        kernels around the plan's launch, bit for bit the halves' path
        (``device_put_x_dd``, ``sell_spmv_dd``, ``combine_f64``) and within
        DD_TOL of the oracle; its device time a call beside that path's."""
        d = D.device_put_sell_dd(res.sell_dd, device=dev)
        if res.sell_dd.row_perm is not None or not all(
                D._pairs(j.bin) for j in D._plan_of(d).launches):
            fail("headline: the dd SELL is not pair bins in the matrix's "
                 "row order")
        x64 = torch.from_numpy(x).to(dev)
        xh, xl = D.device_put_x_dd(x, res.ncols, device=dev)
        y = D.sell_spmv_dd_f64(d, x64)
        if not torch.equal(y.view(torch.int64), combine_f64(
                *D.sell_spmv_dd(d, xh, xl)).view(torch.int64)):
            fail("headline: sell_spmv_dd_f64 differs from the halves' path")
        ref = res.csr.spmv(x)
        err = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
        if not err < DD_TOL:
            fail(f"headline sell_spmv_dd_f64: norm-scaled error {err:.3e}")
        ms = device_time_fn(D.sell_spmv_dd_f64, d, x64, device=dev) * 1e3
        ms_h = device_time_fn(D.sell_spmv_dd, d, xh, xl, device=dev) * 1e3
        return (f"; sell_spmv_dd_f64 {ms:.4f} ms a call (sell_spmv_dd on "
                f"split halves {ms_h:.4f} ms), bit for bit the halves' "
                f"path, norm-scaled error {err:.3e}")

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
    S.panel_reduce.launches = D.panel_reduce_dd.launches = 0
    D.dd_prepare_x.launches = D.dd_join_y.launches = 0
    S.row_gather.launches = S.row_gather_dd.launches = 0
    runs = []
    spmm_runs = []  # (phase, the k-major SELL of its sell_spmm stage, csr)
    phase_csr = {}
    web = road = band64 = headline = None
    flagship_coos, flagship_gen = {}, {}  # the flagship phase's, by phase
    for name, make, layouts, stages, *cfg_kw in phases:
        t0 = time.perf_counter()
        coo = make()
        if name in FLAGSHIP_COOS.values():
            flagship_coos[name] = coo
            flagship_gen[name] = time.perf_counter() - t0
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
            # sell_dd runs the same SELL, slot-packed sg bins and all
            if res.sell_dd is not res.sell:
                fail(f"{name}: sell_dd ran another SELL than sell")
            got_dd = layouts
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
            extra += headline_dd_entry(res, x)
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
                  for s in (res.sell, res.sell_spmm)
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
    n_reduce = (S.panel_reduce.launches, D.panel_reduce_dd.launches)
    panel_notes = []
    for dtype, vals in ((torch.float32, csr.values),
                        (torch.bfloat16, quantize_bf16(csr.values))):
        dps = S.device_put_sell(psell, dtype, device=dev)
        xd = torch.from_numpy(x32).to(dev)
        panel_notes.append(f"{str(dtype)[6:]} " + plan_launches(
            f"panels {dtype}", dps, lambda: S.panel_sell_spmv(dps, xd),
            (*wrappers.values(), S.panel_reduce), S.sell_spmv_launches(dps)))
        y = S.panel_sell_spmv(dps, xd)
        ref = type(csr)(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                        vals).spmv(x32.astype(np.float64))
        sig = difference_metrics(ref, y.cpu().numpy().astype(
            np.float64)).significant_diffs
        if sig:
            fail(f"panels {dtype}: {sig} significant diffs vs the oracle")
    xh, xl = (torch.from_numpy(h).to(dev) for h in split_f64(x))
    dps = D.device_put_sell_dd(psell, device=dev)
    panel_notes.append("dd " + plan_launches(
        "panels dd", dps, lambda: D.panel_sell_spmv_dd(dps, xh, xl),
        (*dd_wrappers.values(), D.panel_reduce_dd),
        D.sell_spmv_dd_launches(dps)))
    y = combine_f64(*D.panel_sell_spmv_dd(dps, xh, xl)).cpu().numpy()
    ref = csr.spmv(x)
    sig = difference_metrics(ref, y).significant_diffs
    dd_err = float(np.abs(y - ref).max() / np.abs(ref).max())
    if sig or not dd_err < DD_TOL:
        fail(f"panels dd: {sig} significant diffs, norm-scaled error "
             f"{dd_err:.3e}")
    if (S.panel_reduce.launches, D.panel_reduce_dd.launches) <= n_reduce:
        fail("panels: panel_reduce or panel_reduce_dd was not launched")
    del dps
    before_mm = {lay: spmm_wrappers[lay].accumulating for lay in got}
    Xp = np.random.default_rng(SEED).standard_normal((csr.ncols, 8),
                                                      dtype=np.float32)
    Y = SM.sell_spmm(S.device_put_sell(psell, device=dev),
                     torch.from_numpy(Xp).to(dev))
    check_spmm("panels sell_spmm", csr, Xp,
               Y.cpu().numpy().astype(np.float64))
    for lay in got:
        if spmm_wrappers[lay].accumulating <= before_mm[lay]:
            fail(f"panels: the {lay} SpMM kernel did not accumulate")
    print(f"[panels] {csr.nrows} rows, {csr.nnz} nnz, "
          f"{len(psell.panels)} panels, bins "
          f"{[[(b.layout, b.k, b.n_groups) for b in p.bins] for p in psell.panels]}, "
          f"dd norm-scaled error {dd_err:.3e}; {'; '.join(panel_notes)}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)

    # the row map's gather: kron through the row-order rule, on the main path
    torch.cuda.empty_cache()
    row_map_rows = row_map_phase(dev)

    launches, launches_dd = counts(), counts(dd_wrappers)
    launches_row_map = {k: getattr(S, k).launches for k in ROW_MAP_KERNELS}
    launches_reduce = {"panel_reduce": S.panel_reduce.launches,
                       "panel_reduce_dd": D.panel_reduce_dd.launches}
    launches_split_join = {k: getattr(D, k).launches
                           for k in SPLIT_JOIN_KERNELS}
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
    for kind, n in (*launches_reduce.items(), *launches_split_join.items(),
                    *launches_row_map.items(), *launches_pr.items()):
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

    # ---- the flagship line (bench.py) at full size on the main path's
    # COOs; its launches are counted from a reset just before the phase ----
    torch.cuda.empty_cache()
    fl_launches = flagship_phase(dev, flagship_coos, flagship_gen)
    del flagship_coos
    for group, ls in (("", launches), (" dd", launches_dd)):
        for key in ls:
            ls[key] += fl_launches[group, key]

    # ---- the solvers at full size; their launches are counted from a reset
    # just before the phase and added to the main path's ----
    torch.cuda.empty_cache()
    solver_launches = solver_phase(dev, phase_csr["headline"])
    for group, ls in (("", launches), (" dd", launches_dd),
                      (" SpMM", launches_mm)):
        for key in ls:
            ls[key] += solver_launches[group, key]

    # ---- the sweep and tune layer at full size through bench.cli; its
    # launches are counted from a reset just before the phase ----
    torch.cuda.empty_cache()
    sweep_launches = sweep_phase(dev)
    for group, ls in (("", launches), (" dd", launches_dd)):
        for key in ls:
            ls[key] += sweep_launches[group, key]

    # ---- the multi-device layer: ranks sharing the card, then NCCL; the
    # ranks count their own launches and the phase returns them ----
    torch.cuda.empty_cache()
    held = {r[0]: (r[1], r[3], r[4]) for r in runs}
    md_launches = multidevice_phase(dev, {
        **{k: held[k] for k in ("headline", "banded_adversarial",
                                "scattered_uniform", "webbase_pr",
                                "road_scattered")},
        "band64_250k": (band64.bsr, band64.csr)})
    for group, ls in (("", launches), (" SpMM", launches_mm),
                      (" PR", launches_pr)):
        for key in ls:
            ls[key] += md_launches.get((group, key), 0)

    # ---- the entry programs: entry(), dryrun_multichip on shared and own
    # cards, the demo; entry() and the ranks count their own launches ----
    torch.cuda.empty_cache()
    ep_launches = entry_programs_phase(dev, smi)
    for group, ls in (("", launches), (" SpMM", launches_mm),
                      (" PR", launches_pr)):
        for key in ls:
            ls[key] += ep_launches.get((group, key), 0)

    # ---- the dd entry's x split and y join at fem3d_cube's shape ----
    split_join_rows = split_join_phase(dev)
    # ---- CG's fused kernels at fem3d_cube's shape, f32 and f64 ----
    cg_rows = {tag: cg_step_phase(dev, dt) for tag, dt in (
        ("", torch.float32), (" f64", torch.float64))}

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
        if getattr(b, "as_pair", None) is not None:
            return (b.as_pair,)  # wl and sg dd: (hi, lo) pairs
        return (b.as_hi, b.as_lo) if hasattr(b, "as_hi") else (b.as_,)

    def hi_plane(b):
        """The bin's values (dd: their hi halves), one per slot."""
        v = value_planes(b)[0]
        return v[..., 0] if v.dim() == 3 else v

    def value_bytes(b):
        """Bytes of values a slot: f32 4, bf16 2, dd 8."""
        return sum(v.element_size() * (v.numel() // hi_plane(b).numel())
                   for v in value_planes(b))

    def tables(b):
        return tuple(t for t in (b.slab_list, b.slab_count, b.group_ids,
                                 b.row_len, b.plane_off, b.row_table)
                     if t is not None)

    def device_bytes(d):
        return sum(t.numel() * t.element_size() for b in d.bins
                   for t in (b.ja, *value_planes(b), *tables(b)))

    def bytes_read(b):
        """Bytes a kernel streams: its planes (a padded sg bin reads only
        its groups' real tiles) and its tables."""
        planes = sum(t.numel() * t.element_size()
                     for t in (b.ja, *value_planes(b)))
        if b.layout == "sg" and b.row_table is None:
            real = int(b.slab_count.clamp(max=b.k).sum())
            planes = planes * real // max(b.n_groups * b.k, 1)
        return planes + sum(t.numel() * t.element_size() for t in tables(b))

    def bin_counts(b, x_rows):
        """The bin's real entries (a value that is not 0, in a slot its
        layout does not mask), the distinct x entries they read and the y
        rows they write (those the plain version sums from a value plane of
        1s at 1s of an ``x_rows``-entry x)."""
        shape, cols, keep, _ = S._SLOTS[b.layout](b)
        vals = hi_plane(b)
        real = vals.reshape(shape) != 0
        if keep is not None:
            real = real & keep
        n_x = int(torch.unique(cols[real]).numel())
        index = {f.name: getattr(b, f.name)
                 for f in dataclasses.fields(S.DeviceBinIndex)}
        ones = S.DeviceSellBin(**index, as_=real.float().reshape(vals.shape))
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

    def shape_note(b):
        """What a bin's kernel launch depends on beyond its planes: a
        k-major bin's lanes a row (dd, one lane: compacted), a padded sg
        bin's chunks a group."""
        if b.layout == "k-major":
            return (f" lanes={S._k_major_lanes(b)}"
                    f"{' compacted' if b.row_table is not None else ''}")
        if b.layout == "sg":
            return (" compacted" if b.row_table is not None
                    else f" chunks={S._sg_chunks(b)}")
        return ""

    def bound_ms(b, xs):
        """The least time of the bin's function (:func:`bin_counts`' bytes
        over the HBM rate; wl: 2-byte codes); returns it and the bin's real
        entries."""
        nnz, n_x, n_y = bin_counts(b, xs[0].numel())
        return need_ms(nnz, value_bytes(b), n_x, n_y, len(xs),
                       2 if b.layout == "wl" else 4), nnz

    def plain_ms(plain, *args, reps=None):
        """``(device ms, call ms)`` of a plain version; one that adds slot
        step by slot step only by call time (:data:`PLAIN_SEQ_REPS`)."""
        if plain in (*(plains[lay] for lay in SEQ_LAYOUTS),
                     *(dd_plains[lay] for lay in SEQ_LAYOUTS_DD),
                     SM.wl_spmm_bin_plain, SM.k_major_spmm_bin_plain):
            ms = time_fn(plain, *args, device=dev, reps=PLAIN_SEQ_REPS,
                         skip=1) * 1e3
            return ms, ms
        kw = {} if reps is None else {"reps": reps}
        return (device_time_fn(plain, *args, device=dev, **kw) * 1e3,
                time_fn(plain, *args, device=dev) * 1e3)

    def check_bin(tag, b, xt, y0, phase):
        want = plains[b.layout](b, xt)
        atol = ATOL_REL * float(want.abs().max())
        rows = b.group_ids.long()
        exact = b.layout in SEQ_LAYOUTS
        err = 0.0
        for accumulate in (False, True):
            y = y0.clone()
            wrappers[b.layout](b, xt, y, accumulate=accumulate)
            got = y.view(-1, 8, 128)[rows]
            exp = want
            if accumulate:
                if exact:  # the kernel's own y + sum
                    exp = y0.view(-1, 8, 128)[rows] + want
                else:
                    got = got - y0.view(-1, 8, 128)[rows]
            e = (got - exp).abs().max().item()
            if not (torch.equal(got, exp) if exact else torch.allclose(
                    got, exp, rtol=RTOL, atol=atol)):
                fail(f"{tag} ({b.layout}, accumulate={accumulate}): "
                     f"max|k-p| = {e}{' (must be equal)' if exact else ''}")
            err = max(err, e)
        st = stats[b.layout]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        y = y0.clone()
        ms_k = device_time_fn(wrappers[b.layout], b, xt, y, device=dev) * 1e3
        ms_p, call_p = plain_ms(plains[b.layout], b, xt)
        call_k = time_fn(wrappers[b.layout], b, xt, y, device=dev) * 1e3
        bound, nnz = bound_ms(b, (xt,))
        print(f"{tag} {b.layout} k={b.k} groups={b.n_groups} span={b.span}"
              f"{shape_note(b)} ja={str(b.ja.dtype)[6:]}"
              f"{' add_into' if b.add_into else ''}: "
              f"device kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms; call "
              f"kernel {call_k:.4f} ms, plain {call_p:.4f} ms; "
              f"planes {bytes_read(b)} B read "
              f"({bytes_read(b) / ms_k / 1e9:.3f} TB/s); bound "
              f"{bound:.4f} ms ({nnz} entries); max|k-p| {err:.3e}",
              flush=True)
        if phase:
            take_row(st, b, nnz, (nnz, ms_k, ms_p, tag, b.k, b.n_groups,
                                  bound, phase, bytes_read(b)))
        return ms_k

    def check_bin_dd(tag, b, xh, xl, y0h, y0l, phase):
        """A dd bin through its kernel, storing and dd-adding onto (y0h,
        y0l), against its plain dd version: compared fp64-combined, or the
        k-major, wl, sb-list and sg ones pair for pair. Its kernel is timed
        on its own (pair bins: the interleaved x table given)."""
        kernel, plain = dd_wrappers[b.layout], dd_plains[b.layout]
        want = plain(b, xh, xl)
        rows = b.group_ids.long()
        base = (y0h.view(-1, 8, 128)[rows], y0l.view(-1, 8, 128)[rows])
        exact = b.layout in SEQ_LAYOUTS_DD
        kw = {"x_pair": D.pack_x_pair(xh, xl)} if D._pairs(b) else {}
        err = 0.0
        for accumulate in (False, True):
            yh, yl = y0h.clone(), y0l.clone()
            kernel(b, xh, xl, yh, yl, accumulate=accumulate, **kw)
            got = (yh.view(-1, 8, 128)[rows], yl.view(-1, 8, 128)[rows])
            exp = dd_add_dd(*base, *want) if accumulate else want
            e = (combine_f64(*got) - combine_f64(*exp)).abs().max().item()
            ok = (all(torch.equal(g, w) for g, w in zip(got, exp)) if exact
                  else e <= DD_TOL * combine_f64(*exp).abs().max().item())
            if not ok:
                fail(f"{tag} ({b.layout} dd, accumulate={accumulate}): "
                     f"max|k-p| = {e}{' (must be equal)' if exact else ''}")
            err = max(err, e)
        st = stats_dd[b.layout]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        yh, yl = y0h.clone(), y0l.clone()
        ms_k = device_time_fn(lambda: kernel(b, xh, xl, yh, yl, **kw),
                              device=dev) * 1e3
        ms_p, call_p = plain_ms(plain, b, xh, xl, reps=PLAIN_DD_REPS)
        call_k = time_fn(lambda: kernel(b, xh, xl, yh, yl, **kw),
                         device=dev) * 1e3
        bound, nnz = bound_ms(b, (xh, xl))
        print(f"{tag} {b.layout} dd k={b.k} groups={b.n_groups} "
              f"span={b.span}{shape_note(b)} ja={str(b.ja.dtype)[6:]}"
              f"{' add_into' if b.add_into else ''}"
              f"{' slots' if b.sg_slots else ''}: device kernel "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms; call kernel "
              f"{call_k:.4f} ms, plain {call_p:.4f} ms; "
              f"planes {bytes_read(b)} B read "
              f"({bytes_read(b) / ms_k / 1e9:.3f} TB/s); bound "
              f"{bound:.4f} ms ({nnz} entries); max|k-p| {err:.3e}",
              flush=True)
        if phase:
            take_row(st, b, nnz, (nnz, ms_k, ms_p, tag, b.k, b.n_groups,
                                  bound, phase, bytes_read(b)))
        return ms_k

    def compacted(b):
        """Whether ``b``'s planes were compacted at upload: wl, sb-list with
        int32 planes, f32/bf16 sg and dd k-major of one lane a row."""
        return b.layout == "wl" or b.row_table is not None

    def padded_check(tag, hb, b, xs, dd):
        """A compacted bin's padded and compacted slots and bytes, and its
        kernel (storing) against the padded layout's result: bit for bit,
        or for sg, whose compacted rows add the same products in another
        order, within f32 rounding."""
        n = (int(b.group_ids.max()) + 1) * 1024
        ys = [torch.zeros(n, device=dev) for _ in xs]
        if dd:
            dd_wrappers[b.layout](b, *xs, *ys)
            want = {"wl": D.wl_padded_plain_dd,
                    "sb-list": D.sb_list_padded_plain_dd,
                    "k-major": D.k_major_padded_plain_dd}[b.layout](hb, *xs)
        else:
            wrappers[b.layout](b, *xs, *ys)
            want = ({"wl": S.wl_padded_plain, "sb-list":
                     S.sb_list_padded_plain, "sg": S.sg_padded_plain}[
                         b.layout](hb, xs[0], b.as_.dtype),)
        rows = b.group_ids.long()
        got = [y.view(-1, 8, 128)[rows] for y in ys]
        if b.layout == "sg":
            ok = torch.allclose(got[0], want[0], rtol=RTOL, atol=ATOL_REL
                                * float(want[0].abs().max()))
        else:
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
        if not ok:
            fail(f"{tag}: the compacted {b.layout} kernel differs from the "
                 "padded layout's result")
        padded, kept = int(np.asarray(hb.ja).size), b.ja.numel()
        entries = int((np.asarray(hb.as_) != 0).sum())
        vb = value_bytes(b)
        same = "bit for bit"
        if b.layout == "wl":
            was = "the packed 1 B lane index"
            now = "2 B codes, row lengths and block offsets"
            index_bytes = 1
        else:
            was = "a 4 B column"
            now = "4 B columns, the row table and warp offsets"
            index_bytes = 4
        if b.layout == "sg":  # the padded kernel read only the real tiles
            padded = int(np.minimum(np.asarray(hb.slab_count).reshape(-1),
                                    hb.k).sum()) * 1024
            was = "a 4 B md word, the real tiles only"
            same = (f"within f32 rounding (max|k-p| "
                    f"{(got[0] - want[0]).abs().max().item():.3e})")
        print(f"{tag} {b.layout} k={hb.k} groups={hb.n_groups}: padded "
              f"{padded} slots ({padded * (vb + index_bytes)} B at {vb} B a "
              f"value and {was}), compacted {kept} slots ({bytes_read(b)} B "
              f"with {now}); {entries} entries, "
              f"{kept / max(entries, 1):.4f}x of them, "
              f"{padded / max(kept, 1):.3f}x fewer slots; kernel equals the "
              f"padded result {same}", flush=True)

    def check_joint(tag, j, xs, dd, members_ms=None):
        """A joint launch of a plan (of more than one bin) storing into y
        against its joint bin's plain version: bit for bit where the
        layout's kernel equals its plain version (:data:`SEQ_LAYOUTS`),
        else at the phase's tolerance; printed with its device time beside
        its members' launches' own (``members_ms``)."""
        b = j.bin
        rows = b.group_ids.long()
        ys = [torch.full(((int(rows.max()) + 1) * 1024,), float("nan"),
                         device=dev) for _ in xs]
        if dd:
            kernel, kw = dd_wrappers[b.layout], (
                {"x_pair": D.pack_x_pair(*xs)} if D._pairs(b) else {})
            want = dd_plains[b.layout](b, *xs)
            exact = b.layout in SEQ_LAYOUTS_DD
        else:
            kernel, kw = wrappers[b.layout], {}
            want = (plains[b.layout](b, *xs),)
            exact = b.layout in SEQ_LAYOUTS
        kernel(b, *xs, *ys, **kw)
        got = [y.view(-1, 8, 128)[rows] for y in ys]
        if exact:
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
        elif dd:
            ok = bool((combine_f64(*got) - combine_f64(*want)).abs().max()
                      <= DD_TOL * combine_f64(*want).abs().max())
        else:
            ok = torch.allclose(got[0], want[0], rtol=RTOL, atol=ATOL_REL
                                * float(want[0].abs().max()))
        if not ok:
            fail(f"{tag}: the joint {b.layout} launch differs from its "
                 "plain version")
        ms = device_time_fn(lambda: kernel(b, *xs, *ys, **kw),
                            device=dev) * 1e3
        alone = ("" if members_ms is None else
                 f", its bins' launches alone {members_ms:.4f} ms together")
        print(f"{tag} {b.layout}{' dd' if dd else ''} joint launch of "
              f"{len(j.members)} bins of {[m.n_groups for m in j.members]} "
              f"groups{' add_into' if j.accumulate else ''}: device kernel "
              f"{ms:.4f} ms{alone}; equals its plain version "
              f"{'bit for bit' if exact else 'within tolerance'}",
              flush=True)
        return ms

    def upload_peak(put):
        """``put()`` and the device bytes it held at its peak beyond what
        was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        d = put()
        torch.cuda.synchronize()
        return d, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated(dev) - base

    for name, sell, _, x, csr in runs:
        uploads = [(dt, False) for dt in (torch.float32, torch.bfloat16)]
        if name in SB_I16_PHASES:
            uploads += [(dt, True) for dt in (torch.float32, torch.bfloat16)]
        for dtype, i16 in uploads:
            d, up_s, peak = upload_peak(lambda: S.device_put_sell(
                sell, dtype, device=dev, sb_i16=i16))
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
            note = plan_launches(f"{name} {dtype} i16={i16}", d,
                                 lambda: S.sell_spmv(d, xt),
                                 tuple(wrappers.values()),
                                 S.sell_spmv_launches(d))
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
                  f"{(y_k - y_p).abs().max().item():.3e}; {note}; plan "
                  f"tables {S.plan_bytes(d)} B; upload {up_s:.3f} s, peak "
                  f"{peak} B{lib}", flush=True)
            y0 = torch.randn(d.num_groups * 1024, device=dev)
            bin_ms = {}
            for i, b in enumerate(d.bins):
                bin_ms[id(b)] = check_bin(
                    f"{tag} bin {i}", b, xt, y0,
                    name if dtype == torch.float32 and not i16 else None)
                if compacted(b):
                    padded_check(f"{tag} bin {i}", sell.bins[i], b, (xt,),
                                 False)
            for i, j in enumerate(d.plan.launches):
                if len(j.members) > 1:
                    check_joint(f"{tag} launch {i}", j, (xt,), False,
                                sum(bin_ms[id(m)] for m in j.members))
            del d, xt, y_k, y_p, y0
            torch.cuda.empty_cache()

    for name, _, sell, x, csr in runs:
        if sell is None:
            continue
        for i16 in (False, True) if name in SB_I16_PHASES else (False,):
            d, up_s, peak = upload_peak(lambda: D.device_put_sell_dd(
                sell, device=dev, sb_i16=i16))
            if i16 and not any(b.ja.dtype == torch.int16 for b in d.bins):
                fail(f"{name}: sb_i16 packed no dd bin")
            if name == "band64_250k" and any(b.row_table is None
                                             for b in d.bins):
                fail(f"{name}: its k-major dd bin was not compacted")
            xh, xl = D.device_put_x_dd(x, sell.ncols, device=dev)
            y_k = combine_f64(*D.sell_spmv_dd(d, xh, xl))
            y_p = combine_f64(*D.sell_spmv_dd_plain(d, xh, xl))
            e = (y_k - y_p).abs().max().item()
            if not e <= DD_TOL * y_p.abs().max().item():
                fail(f"{name} dd i16={i16}: kernels disagree with the plain "
                     f"versions, max|k-p| = {e}")
            note = plan_launches(f"{name} dd i16={i16}", d,
                                 lambda: D.sell_spmv_dd(d, xh, xl),
                                 tuple(dd_wrappers.values()),
                                 D.sell_spmv_dd_launches(d))
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
                  f"bound {need:.4f} ms; max|k-p| {e:.3e}; {note}; plan "
                  f"tables {S.plan_bytes(d)} B; upload {up_s:.3f} s, peak "
                  f"{peak} B{lib}", flush=True)
            y0h = torch.randn(d.num_groups * 1024, device=dev)
            y0l = y0h * 2.0**-30
            per_bin = []  # (bin, its kernel's device ms alone)
            bin_ms = {}
            for i, b in enumerate(d.bins):
                ms = check_bin_dd(f"{tag} bin {i}", b, xh, xl, y0h, y0l,
                                  None if i16 else name)
                bin_ms[id(b)] = ms
                per_bin.append((f"{b.layout} k={b.k} g={b.n_groups}"
                                f"{' add_into' if b.add_into else ''}", ms))
                if compacted(b):
                    padded_check(f"{tag} bin {i}", sell.bins[i], b,
                                 (xh, xl), True)
            per_launch = []
            for i, j in enumerate(d.plan.launches):
                per_launch.append(check_joint(
                    f"{tag} launch {i}", j, (xh, xl), True,
                    sum(bin_ms[id(m)] for m in j.members))
                    if len(j.members) > 1 else bin_ms[id(j.members[0])])
            print(f"{tag} SpMV bin by bin (kernel device ms, each alone): "
                  f"{'; '.join(f'{what} {ms:.4f}' for what, ms in per_bin)}"
                  f"; sum {sum(ms for _, ms in per_bin):.4f} ms; launch by "
                  f"launch {'; '.join(f'{ms:.4f}' for ms in per_launch)}, "
                  f"sum {sum(per_launch):.4f} ms; against the SpMV's "
                  f"{dev_k * 1e3:.4f} ms", flush=True)
            del d, xh, xl, y_k, y_p, y0h, y0l
            torch.cuda.empty_cache()

    def reduce_check(tag, dps, xs, dd):
        """panel_reduce (dd: panel_reduce_dd) on the slices the plan's
        joint launches write for one SpMV of ``dps``, against its plain
        version bit for bit; returns its device ms, the plain version's and
        its bound (the covered slices' rows read once, y written once)."""
        plan = dps.plan
        tabs = [S.panel_x_table(dps, x) for x in xs]
        n = dps.num_groups * 1024
        parts = [torch.empty(plan.slices * n, device=dev) for _ in xs]
        write = D._kernel_writer() if dd else S._run_kernel
        for j in plan.launches:
            write(j.bin, *tabs, *parts, False)
        ys = [torch.empty(n, device=dev) for _ in xs]
        if dd:
            def kernel():
                D.panel_reduce_dd(*parts, plan.cover, *ys)

            def plain():
                return D.panel_reduce_plain_dd(*parts, plan.cover)
        else:
            def kernel():
                S.panel_reduce(parts[0], plan.cover, ys[0])

            def plain():
                return (S.panel_reduce_plain(parts[0], plan.cover),)
        kernel()
        if not all(torch.equal(y, w) for y, w in zip(ys, plain())):
            fail(f"{tag}: panel_reduce differs from its plain version")
        ms = device_time_fn(kernel, device=dev) * 1e3
        ms_p = device_time_fn(plain, device=dev, reps=PLAIN_DD_REPS) * 1e3
        rows = int(plan.cover.sum()) * 1024
        bound = (len(xs) * 4 * (rows + n) + plan.cover.numel()) \
            / HBM_BYTES_PER_S * 1e3
        print(f"{tag} panel_reduce{'_dd' if dd else ''}: {plan.slices} "
              f"slices of {dps.num_groups} groups, {rows} rows covered: "
              f"device kernel {ms:.4f} ms, plain {ms_p:.4f} ms; bound "
              f"{bound:.6f} ms; equals its plain version bit for bit",
              flush=True)
        return ms, ms_p, bound

    reduce_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dps = S.device_put_sell(psell, dtype, device=dev)
        xd = torch.from_numpy(x32).to(dev)
        y_k = S.panel_sell_spmv(dps, xd)
        y_p = S.panel_sell_spmv_plain(dps, xd)
        if not torch.equal(y_k, y_p):
            fail(f"panels {dtype}: kernels differ from the plain versions")
        xt = S.panel_x_table(dps, xd)  # every panel's rebased bins read it
        y0 = torch.randn(dps.num_groups * 1024, device=dev)
        bin_ms = {}
        for p, dsell in enumerate(dps.panels):
            for i, b in enumerate(dsell.bins):
                bin_ms[id(b)] = check_bin(
                    f"[panels] {str(dtype)[6:]} panel {p} bin {i}", b, xt,
                    y0, None)
        for i, j in enumerate(dps.plan.launches):
            check_joint(f"[panels] {str(dtype)[6:]} launch {i}", j, (xt,),
                        False, sum(bin_ms[id(m)] for m in j.members))
        if dtype == torch.float32:
            reduce_rows["panel_reduce"] = reduce_check(
                "[panels] f32", dps, (xd,), False)

    # the whole panel SpMV beside cuSPARSE on the panel phase's matrix; a
    # call queues the plan's few launches, the plain one many: few reps
    ms32 = device_time_fn(S.panel_sell_spmv,
                          S.device_put_sell(psell, device=dev),
                          torch.from_numpy(panel[1]).float().to(dev),
                          device=dev, reps=PLAIN_DD_REPS) * 1e3
    ms_dd = device_time_fn(D.panel_sell_spmv_dd,
                           D.device_put_sell_dd(psell, device=dev),
                           *(torch.from_numpy(h).to(dev)
                             for h in split_f64(panel[1])),
                           device=dev, reps=PLAIN_DD_REPS) * 1e3
    print(f"[panels] panel SpMV device time f32 {ms32:.4f} ms (bound "
          f"{csr_bound_ms(panel[0], 4, 1):.6f})"
          f"{lib_note('panels', *panel, torch.float32)}; dd {ms_dd:.4f} ms "
          f"(bound {csr_bound_ms(panel[0], 8, 2):.6f})"
          f"{lib_note('panels', *panel, torch.float64)}", flush=True)
    dps = D.device_put_sell_dd(psell, device=dev)
    xh, xl = (torch.from_numpy(h).to(dev)
              for h in split_f64(x32.astype(np.float64)))
    y_k = D.panel_sell_spmv_dd(dps, xh, xl)
    y_p = D.panel_sell_spmv_dd_plain(dps, xh, xl)
    if not all(torch.equal(k, p) for k, p in zip(y_k, y_p)):
        fail("panels dd: kernels differ from the plain versions")
    tabs = (S.panel_x_table(dps, xh), S.panel_x_table(dps, xl))
    y0h = torch.randn(dps.num_groups * 1024, device=dev)
    bin_ms = {}
    for p, dsell in enumerate(dps.panels):
        for i, b in enumerate(dsell.bins):
            bin_ms[id(b)] = check_bin_dd(f"[panels] dd panel {p} bin {i}", b,
                                         *tabs, y0h, y0h * 2.0**-30, None)
    for i, j in enumerate(dps.plan.launches):
        check_joint(f"[panels] dd launch {i}", j, tabs, True,
                    sum(bin_ms[id(m)] for m in j.members))
    reduce_rows["panel_reduce_dd"] = reduce_check("[panels] dd", dps,
                                                  (xh, xl), True)

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
        rows = b.group_ids.long()
        err = 0.0
        # both plain versions add in the kernels' order: equal bit for bit
        for accumulate in (False, True):
            y = rhs_copy(y0)
            kernel(b, xt, y, accumulate=accumulate)
            got = y.view(-1, 8, 128, rhs)[rows]
            exp = y0.view(-1, 8, 128, rhs)[rows] + want if accumulate \
                else want
            e = (got - exp).abs().max().item()
            if not torch.equal(got, exp):
                fail(f"{tag} ({b.layout} SpMM, accumulate={accumulate}): "
                     f"max|k-p| = {e} (must be equal)")
            err = max(err, e)
        path = ""
        if b.layout == "k-major":
            staged = SM.staged_blocks(b)
            span = b.x_window[:, 1].float()
            path = (f"; blocks on x staged in shared memory {staged}, on "
                    f"the x table {b.n_groups * 8 - staged} (window spans "
                    f"median {int(span.median())}, max {int(span.max())} "
                    f"rows; staged up to {b.window_rows})")
        st = mm_stats[b.layout]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        if phase is None:
            return
        y = rhs_copy(y0)
        ms_k = device_time_fn(kernel, b, xt, y, device=dev) * 1e3
        ms_p = plain_ms(plain, b, xt, reps=PLAIN_SPMM_REPS)[0]
        call_k = time_fn(kernel, b, xt, y, device=dev) * 1e3
        if b.layout == "k-major" and b.window_rows:
            # the same bin with staging off: every block on the x table
            off = dataclasses.replace(b, window_rows=0)
            y_off = rhs_copy(y0)
            kernel(off, xt, y_off)
            if not torch.equal(y_off.view(-1, 8, 128, rhs)[rows], want):
                fail(f"{tag}: the k-major SpMM kernel without staging "
                     "differs from its plain version")
            ms_off = device_time_fn(kernel, off, xt, y_off, device=dev) * 1e3
            path += f"; staging off {ms_off:.4f} ms"
        nnz, n_x, n_y = bin_counts(b, xt.shape[0])
        bound, by = spmm_need(nnz, b.as_.element_size(), n_x, n_y, rhs,
                              col_bytes=2 if b.layout == "wl" else 4)
        planes = nbytes(b.ja, b.as_) + (n_x + n_y) * rhs * 4
        print(f"{tag} {b.layout} SpMM R={rhs} k={b.k} groups={b.n_groups}: "
              f"device kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms; call "
              f"kernel {call_k:.4f} ms; planes, x and y rows {planes} B "
              f"({planes / ms_k / 1e9:.3f} TB/s); "
              f"{2 * nnz * rhs / ms_k / 1e6:.1f} GFLOPS; bound {bound:.4f} "
              f"ms ({by}, {nnz} entries); max|k-p| {err:.3e}{path}",
              flush=True)
        if rhs == SPMM_RHS and (st["best"] is None or nnz > st["best"][0]):
            st["best"] = (nnz, ms_k, ms_p, tag, b.k, b.n_groups, bound, by,
                          phase, bytes_read(b))

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

    def spmm_regs():
        """(layout, value type, lanes a row) -> (registers, spill-store
        bytes) of the SpMM kernels, from the build's ``-Xptxas -v``
        output."""
        out, cur, spill = {}, None, 0
        for line in _build.build_log().splitlines():
            m = re.search(r"Compiling entry function '_ZN4sell\d+"
                          r"(\w+?)_spmm_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                          line)
            if m:
                cur = (m[1].replace("_", "-"),
                       "f32" if m[2] == "f" else "bf16", int(m[3]))
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m[1])
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                out[cur], cur = (int(m[1]), spill), None
        return out

    def rhs_sweep(name, d, rhs_list):
        """Each bin of ``d`` (k-major or wl) through its SpMM kernel at every
        R of ``rhs_list``, storing: equal to its plain version bit for bit,
        and its device time. A wl bin also on the raw X where R is a
        multiple of 4 (equal bit for bit), with its NW, L, the kernel's
        registers and spills and the bin's bound at each R; an all-wl
        ``sell_spmm`` on the raw X equals it on the table bit for bit."""
        times, counts = [], {}
        regs = spmm_regs()
        for rhs in rhs_list:
            X = np.random.default_rng(SEED).standard_normal((d.ncols, rhs),
                                                            dtype=np.float32)
            xt = SM.device_put_x_multi(X, d.ncols, device=dev)
            Xd = torch.from_numpy(X).to(dev)
            raw = rhs % 4 == 0
            for i, b in enumerate(d.bins):
                kernel, plain = spmm_wrappers[b.layout], SM._PLAIN[b.layout]
                want = plain(b, xt)
                rows = b.group_ids.long()
                for x in (xt, Xd) if raw and b.layout == "wl" else (xt,):
                    y = SM._rhs_buffer(d.num_groups * 1024, rhs, dev)
                    kernel(b, x, y)
                    if not torch.equal(y.view(-1, 8, 128, rhs)[rows], want):
                        fail(f"[{name}] bin {i} {b.layout} SpMM R={rhs} "
                             f"({'raw X' if x is Xd else 'x table'}): the "
                             "kernel differs from its plain version")
                ms = device_time_fn(kernel, b, xt, y, device=dev) * 1e3
                note = ""
                if b.layout == "wl":
                    if i not in counts:
                        counts[i] = bin_counts(b, xt.shape[0])
                    nnz, n_x, n_y = counts[i]
                    bound, by = spmm_need(nnz, b.as_.element_size(), n_x,
                                          n_y, rhs, col_bytes=2)
                    dtype = "bf16" if b.as_.dtype == torch.bfloat16 else "f32"
                    lanes = 1 << (SM._width(rhs) // 4 - 1).bit_length()
                    r, sp = regs.get(("wl", dtype, lanes), ("?", "?"))
                    note = (f" (NW={b.nw}, L={b.span}, {nnz} entries; {r} "
                            f"registers, {sp} B spilled; bound {bound:.4f} "
                            f"ms by {by}, {bound / ms:.1%} of it)")
                times.append(f"bin {i} R={rhs} {ms:.4f}{note}")
            if all(b.layout == "wl" for b in d.bins) and raw:
                if SM._x_table(d, Xd) is not Xd or not torch.equal(
                        SM.sell_spmm(d, Xd), SM.sell_spmm(d, xt)):
                    fail(f"[{name}] sell_spmm R={rhs}: the raw X is packed, "
                         "or its result differs from the x table's")
        layouts = "/".join(sorted({b.layout for b in d.bins}))
        print(f"[{name}] {layouts} SpMM by R (device ms, storing; each equal "
              f"to its plain version bit for bit): {'; '.join(times)}",
              flush=True)

    for name, sell_mm, csr in spmm_runs:
        d = S.device_put_sell(sell_mm, device=dev)
        big = name == "banded_adversarial"
        spmm_phase(name, d, csr, SPMM_RHS, name, sell_mm if big else None)
        if name in ("banded_adversarial", "band64_250k"):
            rhs_sweep(name, d, SPMM_SWEEP_RHS)
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
    rhs_sweep("headline", d, WL_SWEEP_RHS)
    # cuSPARSE SpMM at the sweep's other R: the wl rows' library yardstick
    lib_by_r = {rhs: cusparse_spmm("headline", csr, np.random.default_rng(
        SEED).standard_normal((csr.ncols, rhs), dtype=np.float32))
        for rhs in WL_SWEEP_RHS}
    print(f"[headline] cuSPARSE SpMM device ms by R: "
          f"{ {r: round(v, 4) for r, v in lib_by_r.items()} }", flush=True)
    columns_equal_spmv("[headline] wl", d, np.random.default_rng(
        SEED).standard_normal((csr.ncols, SPMM_RHS), dtype=np.float32))
    del d, headline
    torch.cuda.empty_cache()
    dps = S.device_put_sell(psell, device=dev)
    Xd = torch.from_numpy(Xp).to(dev)
    xt = SM._pack_rows(Xd, dps.x_rows)  # the panels' rebased columns
    y0 = rhs_copy(torch.randn(dps.num_groups * 1024, 8, device=dev))
    for p, dsell in enumerate(dps.panels):
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

    # ---- the stored-zero rule: one entry of a column stored as 0, x = inf
    # at that column; every SELL layout, f32 and dd ----
    def column_once(csr, keep, value):
        """``csr`` with every entry of entry ``keep``'s column removed but
        that one, which holds ``value`` (None: removed too); and the
        column."""
        c = int(csr.col_idx[keep])
        e = np.arange(csr.nnz)
        mask = (csr.col_idx != c) | ((e == keep) & (value is not None))
        vals = np.where(e == keep, 0.0 if value is None else value,
                        csr.values)
        row_ids = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
        ptr = np.concatenate([[0], np.cumsum(np.bincount(
            row_ids[mask], minlength=csr.nrows))]).astype(csr.row_ptr.dtype)
        return CSRMatrix(csr.nrows, csr.ncols, ptr, csr.col_idx[mask],
                         vals[mask]), c

    def holding_bins(csr, keep, kw, i16):
        """The layouts of the bins that hold entry ``keep`` once its column
        is its own: with a 1 there, a one-hot x lights only them."""
        one, c = column_once(csr, keep, 1.0)
        d = S.device_put_sell(SellMatrix.from_csr(one, **kw), device=dev,
                              sb_i16=i16)
        e = torch.zeros(S.slab_table_rows(csr.ncols) * 128, device=dev)
        e[c] = 1.0
        lit = set()
        for b in d.bins:
            y = torch.zeros(d.num_groups * 1024, device=dev)
            wrappers[b.layout](b, e, y)
            if y.abs().max() > 0:
                lit.add(b.layout)
        return lit

    t0 = time.perf_counter()
    zero_cases = [
        # (case, matrix, SellMatrix.from_csr keywords, int16 sb planes)
        ("k-major", lambda: banded(4096, 24, 512, seed=0),
         {"layout": "k-major"}, False),
        ("sb-major", lambda: banded(4096, 24, 512, seed=0),
         {"layout": "sb-major"}, False),
        ("sb-list", lambda: banded(4096, 24, 512, seed=0),
         {"layout": "sb-list"}, False),
        ("sb-list i16", lambda: banded(4096, 24, 512, seed=0),
         {"layout": "sb-list"}, True),
        ("wl", lambda: banded(4096, 18, 40, seed=2), {"layout": "wl"}, False),
        ("sg slots", lambda: random_general(20000, 20000, 2.5e-4, seed=8),
         {"layout": "sg"}, False),
        ("sg rows", lambda: random_general(20000, 20000, 2.5e-4, seed=8),
         {"layout": "sg", "sg_slots": False}, False),
    ]
    zero_notes = []
    for case, make, kw, i16 in zero_cases:
        full = CSRMatrix.from_coo(make())
        lay = case.split()[0]
        start = int(full.row_ptr[full.nrows // 2])
        keep = next((e for e in range(start, start + 40)
                     if holding_bins(full, e, kw, i16) == {lay}), None)
        if keep is None:
            fail(f"zero rule {case}: no entry of the middle rows lies in a "
                 f"{lay} bin")
        csr, c = column_once(full, keep, 0.0)
        ref_csr, _ = column_once(full, keep, None)
        sell = SellMatrix.from_csr(csr, **kw)
        x = np.random.default_rng(SEED).standard_normal(csr.ncols)
        x[c] = np.inf
        ref32 = torch.from_numpy(ref_csr.spmv(x.astype(np.float32).astype(
            np.float64))).to(dev)
        y = S.sell_spmv(S.device_put_sell(sell, device=dev, sb_i16=i16),
                        S.device_put_x(x, csr.ncols, device=dev)).double()
        ref = torch.from_numpy(ref_csr.spmv(x)).to(dev)
        y_dd = D.sell_spmv_dd_f64(D.device_put_sell_dd(sell, device=dev,
                                                       sb_i16=i16),
                                  torch.from_numpy(x).to(dev))
        for what, got, want, ok in (
                ("f32", y, ref32, lambda g, w: torch.allclose(
                    g, w, rtol=RTOL, atol=ATOL_REL * float(w.abs().max()))),
                ("dd", y_dd, ref, lambda g, w: bool(
                    (g - w).abs().max() <= DD_TOL * w.abs().max()))):
            if not (torch.isfinite(got).all() and ok(got, want)):
                fail(f"zero rule {case} {what}: a stored zero with x = inf "
                     f"at its column gave {int((~torch.isfinite(got)).sum())} "
                     f"rows that are not finite, max|y - y_ref| "
                     f"{(got - want).abs().max().item():.3e}")
        zero_notes.append(f"{case} (entry {keep}, column {c})")
    print(f"[zero rule] a stored zero with x = inf at its column adds "
          f"nothing, f32 and dd, every row equal to the oracle without it: "
          f"{'; '.join(zero_notes)}; phase {time.perf_counter() - t0:.1f} s",
          flush=True)

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
            nnz, ms_k, ms_p, tag, k, ng, bound, phase, planes = \
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
                "library_ms": library[phase, lib_dtype][0],
                "plane_bytes": planes})
    for kname, replaces in REDUCE_KERNELS.items():
        ms_k, ms_p, bound = reduce_rows[kname]
        print(f"{kname}: device times at the panel phase's fem_3d(10, 10, "
              f"10) in 1024-column panels")
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/panel_reduce.cu", "replaces": replaces,
            "launches": launches_reduce[kname], "max_abs_err": 0.0,
            "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None})
    for kname, replaces in SPLIT_JOIN_KERNELS.items():
        ms_k, ms_p, bound = split_join_rows[kname]
        print(f"{kname}: device times at fem3d_cube's {FEM3D_COLS} columns "
              f"(split_join phase)")
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/dd_split_join.cu", "replaces": replaces,
            "launches": launches_split_join[kname], "max_abs_err": 0.0,
            "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None})
    for tag, kname in ((t, k) for t in cg_rows for k in CG_KERNELS):
        ms_k, ms_p, bound, err = cg_rows[tag][kname]
        print(f"{kname}{tag}: device times at fem3d_cube's {FEM3D_COLS} rows,"
              f" {tag.strip() or 'f32'} (cg_step phase); launches in the "
              "solver phase")
        summary.append({
            "name": kname + tag.replace(" ", "_"), "route": "cuda",
            "source": f"{PKG}/csrc/cg_step.cu", "replaces": CG_REPLACES,
            "launches": solver_launches[" CG" + tag, kname],
            "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None})
    for kname, replaces in ROW_MAP_KERNELS.items():
        ms_k, ms_p, bound = row_map_rows[kname]
        print(f"{kname}: device times at kron SCALE {ROW_MAP_SCALES[1]}'s "
              f"row map (row_map phase)")
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"{PKG}/csrc/row_map.cu", "replaces": replaces,
            "launches": launches_row_map[kname], "max_abs_err": 0.0,
            "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None})
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
        extra = {}
        if key in BSR.ROUTES:
            ms_k, ms_p, bound, by, lib = bsr_rows[key]
            where = f"band64_250k f32, B={BSR_RHS[0]}"
        else:
            nnz, ms_k, ms_p, tag, k, ng, bound, by, phase, planes = \
                mm_stats[key]["best"]
            extra = {"plane_bytes": planes}
            lib = cusparse_mm[phase, SPMM_RHS]
            where = f"{tag}, k={k}, {ng} groups, {nnz} entries, R={SPMM_RHS}"
        print(f"{kname}: device times at its largest main-path run "
              f"({where}, f32 values)")
        summary.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_mm[key],
            "max_abs_err": mm_stats[key]["max_abs_err"], "ms": ms_k,
            "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, **extra})
    print(f"smoke ran {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
