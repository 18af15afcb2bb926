"""The port's ``run_matrix`` against the JAX harness's, stage for stage.

One small matrix goes through the JAX ``run_matrix`` (its Pallas kernels in
interpret mode on the CPU) and through the port's (the plain versions on the
CPU) with the same knobs: ``dtype`` float32 and bfloat16, the default SELL
layout and ``sell_layout="sb-list"`` with ``reorder="rcm"``. Both must run
the same stages (JAX ``xla_csr`` ≙ ``csr``, ``xla_ell`` ≙ ``ell``,
``pallas_*`` ≙ the port's kernel stages) and skip the same ones, with the
same ``significant_diffs`` at the default tolerances, the same reordering
statistics, the same SELL and SELL-sigma bins and the same HLL shape.
power_law's HLL has a block MAXNZ past 256, which both harnesses skip.
"""

import pytest

from sparsematrixvectormultiplication_tpu.bench.harness import (
    BenchConfig as JConfig,
    run_matrix as jax_run_matrix,
)
from sparsematrixvectormultiplication_tpu.models import synthetic as jsyn
from sparsematrixvectormultiplication_tpu_torch.bench.harness import (
    BenchConfig,
    run_matrix,
)
from sparsematrixvectormultiplication_tpu_torch.models import synthetic as syn

# JAX harness stage -> the port's
STAGE_OF = {"serial_csr": "serial_csr", "serial_hll": "serial_hll",
            "xla_csr": "csr", "xla_ell": "ell", "pallas_sell": "sell",
            "pallas_hll": "hll", "pallas_sell_sigma": "sell_sigma",
            "pallas_pr": "pr"}
MATRICES = {"road": lambda s: s.road_network(2000, seed=5),
            "power_law": lambda s: s.power_law(4000, 4, seed=3)}
CASES = {
    "road-f32": ("road", "float32", {}),
    "road-bf16": ("road", "bfloat16", {}),
    "road-f32-sblist-rcm": ("road", "float32",
                            {"sell_layout": "sb-list", "reorder": "rcm"}),
    "road-bf16-sblist-rcm": ("road", "bfloat16",
                             {"sell_layout": "sb-list", "reorder": "rcm"}),
    "power_law-f32": ("power_law", "float32", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matrix_matches_the_jax_harness(case):
    matrix, dtype, knobs = CASES[case]
    mine = run_matrix(matrix, MATRICES[matrix](syn), BenchConfig(
        iterations=1, skip=0, rounds=1, dtype=dtype,
        stages=tuple(STAGE_OF.values())[1:], **knobs),
        log=lambda m: None, device="cpu")
    theirs = jax_run_matrix(matrix, MATRICES[matrix](jsyn), JConfig(
        iterations=1, skip=0, rounds=1, dtype=dtype,
        flush_between_stages=False, kernels=tuple(STAGE_OF), **knobs),
        log=lambda m: None)
    ran = {STAGE_OF[s]: r for s, r in theirs.stages.items()}
    assert set(mine.stages) == set(ran), (mine.skipped, sorted(ran))
    assert set(mine.skipped) == set(STAGE_OF.values()) - set(ran)
    for stage, r in ran.items():
        assert (mine.stages[stage].diff.significant_diffs
                == r.diff.significant_diffs), stage
    if matrix == "power_law":
        assert "MAXNZ" in mine.skipped["hll"]
    mf, tf = mine.format_stats, theirs.format_stats
    for key in ("sell", "sell_sigma", "pr"):
        for stat in ("bin_layouts", "bin_ks", "padded_nnz"):
            if stat in tf.get(key, {}):
                assert mf[key][stat] == tf[key][stat], (key, stat)
    assert mf["hll"] == tf["hll"]
    if knobs.get("reorder"):
        for stat in ("applied", "bandwidth_before", "bandwidth_after"):
            assert mf["reorder"][stat] == tf["reorder"][stat], stat
        assert {b.layout for b in mine.sell.bins} == {"sb-list"}
