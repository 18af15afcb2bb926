"""The flagship SpMV line (≙ the JAX repo's ``bench.py``).

    python -m sparsematrixvectormultiplication_tpu_torch.bench

runs bench.py's three matrices through :func:`.harness.run_matrix` on the
card, x = 1, and prints ONE JSON line, the last line on stdout; every log
goes to stderr:

* ``fem3d_cube``, ``fem_3d(60, 60, 60, dof=3, seed=1)`` (50,757,768 nnz, a
  Cube_Coup_dt0-class FEM matrix): ``sell``, ``sell_bf16`` and ``sell_dd``;
  its SELL must convert to wl bins;
* ``banded_adversarial``, ``banded(250_000, 60, 2500, seed=1)``: ``sell``
  and ``sell_dd``; sb-major bins;
* ``road_scattered``, ``road_network(1_200_000, seed=1)``: ``sell`` with
  ``sell_layout="sb-list"``, as bench.py forces it; sb-list bins.

``serial_csr``, the host fp64 oracle, runs on each. A conversion that gives
other bin layouts than these raises: the line would measure something else.

The line has bench.py's keys, computed as bench.py computes them (GFLOPS =
2·nnz/t over ``StageResult.seconds``, rounded as bench.py rounds them), the
metric renamed ``sell_f32_gflops_fem3d_51Mnnz``, and beside them only
``device`` and ``power_limit_w`` (``torch.cuda.get_device_name``,
``nvidia-smi``), ``setup_s`` (per matrix, the seconds of generation, of the
CSR and SELL conversions and of the stages' uploads, apart from the timed
stages), ``wall_s`` and ``reps`` (per matrix and stage, the calls a timing
round ran).

The statistic is the port's (:mod:`.harness`): the best of ``rounds``
device times of back-to-back calls behind a spin after ``flush_hbm``, the
reps capped at ``MAX_QUEUED_LAUNCHES`` queued launches (a SpMV of several
bins gets fewer than bench.py's 256). It is not the JAX chained-slope
timer, and the harness flushes before every stage where bench.py asked it
not to.

``valid`` is stricter than bench.py's (``significant_diffs == 0 or
mean_rel_err < 1e-4`` on the f32 stage alone): every stage reported has
``significant_diffs == 0`` against the fp64 oracle (bf16: against the
oracle of the bf16-rounded values), and every dd stage also a norm-scaled
error below 1e-12. When it is false the line is still printed and the exit
code is 1. A matrix that fails raises (bench.py turned the road matrix's
failure into null keys); the program then prints ``{"metric": ...,
"error": ...}`` and exits 2, as it does without a CUDA device: it never
carries on on the CPU. The per-matrix functions take ``device=`` and run
the kernels' plain versions on a CPU device (the tests do, at small sizes).

Not ported, each a workaround for the TPU runtime: the wait for a busy
measurement pipeline (one TPU process at a time), the warm-up subprocess
for the first transfer's stall, the ``SPMV_WL_PACK`` proof file (the port
packs wl planes by default) and the JAX compile cache.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import torch

from .harness import BenchConfig, MatrixResult, run_matrix

__all__ = ["METRIC", "BASELINE_GFLOPS", "ROAD_REF_WARP_GFLOPS", "MATRICES",
           "run_fem3d_cube", "run_banded_adversarial", "run_road_scattered",
           "make_matrix", "stage_failures", "flagship_record", "card", "run",
           "main"]

METRIC = "sell_f32_gflops_fem3d_51Mnnz"
# The reference project's own CUDA results on its own (unnamed) GPU: its
# warp-per-row CSR kernel in fp64 on Cube_Coup_dt0 (BASELINE.md:5, :28) and
# on roadNet-PA (BASELINE.md:36). Neither is a TPU number nor this card's.
BASELINE_GFLOPS = 47.09
ROAD_REF_WARP_GFLOPS = 2.59
DD_TOL = 1e-12   # a dd stage's norm-scaled error, at most
ROUNDS = 2       # bench.py's timing rounds

# name -> (generator, arguments, stages, sell_layout, calls a timing round,
# the SELL bin layouts the conversion must give): bench.py:120-171
MATRICES = {
    "fem3d_cube": ("fem_3d", (60, 60, 60), ("sell", "sell_bf16", "sell_dd"),
                   "auto", 256, frozenset({"wl"})),
    "banded_adversarial": ("banded", (250_000, 60, 2500), ("sell", "sell_dd"),
                           "auto", 256, frozenset({"sb-major"})),
    "road_scattered": ("road_network", (1_200_000,), ("sell",), "sb-list",
                       128, frozenset({"sb-list"})),
}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_matrix(name: str, *args):
    """bench.py's COO of matrix ``name`` (seed 1), or with generator
    arguments ``args`` in place of bench.py's (``fem_3d`` takes dof=3)."""
    from ..models import synthetic

    gen, full = MATRICES[name][:2]
    kw = {"dof": 3} if gen == "fem_3d" else {}
    return getattr(synthetic, gen)(*(args or full), **kw, seed=1)


def _run(name, coo, device, log, layouts, iterations):
    from ..entry import device_or_raise

    device = device_or_raise(device)
    _, _, stages, sell_layout, full_iterations, full_layouts = MATRICES[name]
    cfg = BenchConfig(iterations=iterations or full_iterations,
                      rounds=ROUNDS, stages=stages, sell_layout=sell_layout)
    if device.type == "cuda":
        torch.cuda.init()  # the peak counters exist once CUDA is set up
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = run_matrix(name, coo, cfg, log=log, device=device)
    want = full_layouts if layouts is None else set(layouts)
    got = {b.layout for b in res.sell.bins}
    log(f"[{name}] SELL bins (layout, k, groups): "
        f"{[(b.layout, b.k, b.n_groups) for b in res.sell.bins]}")
    if got != want:
        raise RuntimeError(f"{name}: the conversion gave layouts "
                           f"{sorted(got)}, not {sorted(want)}: the line "
                           "would measure another kernel")
    peak = (f", peak device memory {torch.cuda.max_memory_allocated(device)} "
            "B" if device.type == "cuda" else "")
    log(f"[{name}] {time.perf_counter() - t0:.1f} s{peak}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def run_fem3d_cube(coo, device="cuda", log=_log, *, layouts=None,
                   iterations=None) -> MatrixResult:
    """fem3d_cube's stages on ``coo`` (bench.py:129-138): ``sell``,
    ``sell_bf16`` and ``sell_dd``. The conversion must give ``layouts``
    (default: wl bins); ``iterations`` defaults to bench.py's 256."""
    return _run("fem3d_cube", coo, device, log, layouts, iterations)


def run_banded_adversarial(coo, device="cuda", log=_log, *, layouts=None,
                           iterations=None) -> MatrixResult:
    """banded_adversarial's stages on ``coo`` (bench.py:140-149): ``sell``
    and ``sell_dd``; default layouts: sb-major."""
    return _run("banded_adversarial", coo, device, log, layouts, iterations)


def run_road_scattered(coo, device="cuda", log=_log, *, layouts=None,
                       iterations=None) -> MatrixResult:
    """road_scattered's stage on ``coo`` (bench.py:151-171): ``sell``,
    forced to sb-list; default layouts: sb-list; ``iterations`` defaults to
    bench.py's 128."""
    return _run("road_scattered", coo, device, log, layouts, iterations)


def stage_failures(res: MatrixResult) -> list:
    """What keeps ``res`` from being valid: each stage with significant
    differences, each dd stage with a norm-scaled error not below
    :data:`DD_TOL`."""
    out = []
    for name, st in res.stages.items():
        if st.diff.significant_diffs:
            out.append(f"{res.name} {name}: {st.diff.significant_diffs} "
                       "significant diffs")
        if name.endswith("_dd") and not st.norm_err < DD_TOL:
            out.append(f"{res.name} {name}: norm-scaled error "
                       f"{st.norm_err:.3e} >= {DD_TOL}")
    return out


def _setup_s(res: MatrixResult, generate_s: float) -> dict:
    fs = res.format_stats
    return {"generate": generate_s,
            "convert": fs["convert_csr_s"] + fs["convert_sell_s"],
            "upload": sum(v for k, v in fs.items()
                          if k.startswith("upload_"))}


def flagship_record(results: dict, *, device: str, power_limit_w,
                    wall_s: float, generate_s: dict, log=_log) -> dict:
    """The JSON line from the three matrices' results (``results``: name
    -> :class:`MatrixResult`), bench.py:178-204's keys and arithmetic plus
    ``device``, ``power_limit_w``, ``setup_s``, ``wall_s`` and ``reps``."""
    res, res2, res3 = (results[n] for n in MATRICES)
    s, dd, b16 = (res.stages[k] for k in ("sell", "sell_dd", "sell_bf16"))
    s2, dd2 = res2.stages["sell"], res2.stages["sell_dd"]
    s3 = res3.stages["sell"]
    failures = [f for r in (res, res2, res3) for f in stage_failures(r)]
    for f in failures:
        log(f"not valid: {f}")
    return {
        "metric": METRIC,
        "value": round(s.gflops, 3),
        "unit": "GFLOPS",
        "vs_baseline": round(s.gflops / BASELINE_GFLOPS, 4),
        "valid": not failures,
        "mean_rel_err": s.diff.mean_rel_err,
        "nnz": res.nnz,
        "time_ms": round(s.seconds * 1e3, 3),
        "fp64_dd_gflops": round(dd.gflops, 3),
        "fp64_dd_vs_baseline": round(dd.gflops / BASELINE_GFLOPS, 4),
        "fp64_dd_max_rel_err": dd.diff.max_rel_err,
        "bf16_gflops": round(b16.gflops, 3),
        "bf16_vs_baseline": round(b16.gflops / BASELINE_GFLOPS, 4),
        "adversarial_banded_f32_gflops": round(s2.gflops, 3),
        "adversarial_banded_dd_gflops": round(dd2.gflops, 3),
        "scattered_road_f32_gflops": round(s3.gflops, 3),
        "scattered_road_vs_ref_warp": round(s3.gflops / ROAD_REF_WARP_GFLOPS,
                                            3),
        "device": device,
        "power_limit_w": power_limit_w,
        "setup_s": {n: _setup_s(results[n], generate_s[n]) for n in MATRICES},
        "wall_s": wall_s,
        "reps": {n: {k: st.extra["reps"] for k, st in results[n].stages.items()
                     if "reps" in st.extra} for n in MATRICES},
    }


def card(device, log=_log) -> tuple:
    """``(name, power limit in W)`` of CUDA ``device``: the name from
    ``torch.cuda.get_device_name``, the limit from ``nvidia-smi``."""
    device = torch.device(device)
    index = device.index if device.index is not None else 0
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"card: {line}")
    return torch.cuda.get_device_name(device), float(
        line.rsplit(",", 1)[1].split()[0])


def run(log=_log) -> dict:
    """Generate bench.py's three matrices, run each on the card and return
    the record; raises without CUDA."""
    from ..entry import device_or_raise
    from ..ops import _build

    t_all = time.perf_counter()
    device = device_or_raise("cuda")
    name, power_limit_w = card(device, log)
    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    runners = {"fem3d_cube": run_fem3d_cube,
               "banded_adversarial": run_banded_adversarial,
               "road_scattered": run_road_scattered}
    results, generate_s = {}, {}
    for m, fn in runners.items():
        t0 = time.perf_counter()
        coo = make_matrix(m)
        generate_s[m] = time.perf_counter() - t0
        log(f"[{m}] generated in {generate_s[m]:.1f} s: {coo.nnz} nnz")
        results[m] = fn(coo, device, log)
        del coo
    wall_s = time.perf_counter() - t_all
    log(f"total bench time: {wall_s:.1f} s")
    return flagship_record(results, device=name, power_limit_w=power_limit_w,
                           wall_s=wall_s, generate_s=generate_s, log=log)


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m sparsematrixvectormultiplication_tpu_torch.bench",
        description="The flagship SpMV line on the card: fem3d_cube, "
                    "banded_adversarial and road_scattered; one JSON line "
                    "on stdout, logs on stderr").parse_args(argv)
    try:
        record = run()
    except Exception as e:  # noqa: BLE001 — reported, and the exit is 2
        _log(traceback.format_exc())
        print(json.dumps({"metric": METRIC,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        return 2
    print(json.dumps(record), flush=True)
    return 0 if record["valid"] else 1
