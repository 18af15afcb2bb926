"""sparsematrixvectormultiplication_tpu_torch — sparse SpMV and SpMM on PyTorch
and CUDA.

The port of ``sparsematrixvectormultiplication_tpu`` (JAX/Pallas, the
reference) to PyTorch with hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``). It carries its own numpy copies of the host layers (Matrix
Market IO, COO/CSR/SELL conversion, synthetic matrices, validation) and runs
SELL SpMV on every bin layout (k-major, window-layered, sb-major, sb-list,
sg) and over column panels, f32 or bf16 values with f32 x and sums, or
fp64-class double-double values, x and sums; the scattered regime through
the PR (permutation-routed) layout and the locality split (near SELL plus a
PR far side), f32 and double-double; ``auto_device_op``, which picks
one of the three layouts; and multi-RHS SpMM: ``sell_spmm`` over k-major and
wl SELL bins (R <= 32 right-hand sides, each entry read once for all) and
``bsr_spmm`` over 128x128 dense blocks (``BSRMatrix``), f32 or bf16 values
with f32 sums. Beside them: HLL (``HLLMatrix``, on the SELL kernels), plain
PyTorch CSR and ELL SpMV, RCM reordering, the benchmark harness
``run_matrix`` and the card's bandwidth probe (``bench.bw_probe``). On top of
the kernels, the solvers of ``solvers/``: CG and PCG (Jacobi, Chebyshev),
``cg_sell`` over the device containers, multi-RHS ``cg_multi``, BiCGSTAB,
GMRES(m), power iteration and PageRank, Lanczos, block subspace iteration
and mixed-precision iterative refinement, each a Python loop over any
matvec or matmat with its state on the device. Above the harness, the
sweep and tune layer: the directory sweep ``python -m
sparsematrixvectormultiplication_tpu_torch.bench.cli`` with checkpoint and
resume, the reference-schema CSVs (``bench.csv_report``) and their report
(``bench.report``), the SELL and hack-size autotuner (``tune.autotune``,
measured on the card), the K-bin ladder sweep (``bench.scale``) and
``torch.profiler`` traces (``utils.profiling``). Across devices, the
multi-device layer of ``parallel/``: one rank per shard on a
``torch.distributed`` device mesh (NCCL, or gloo for CPU ranks and ranks
that share a card) for row-sharded SELL SpMV and SpMM, column-sharded
SELL, BSR SpMM, PR and the locality split, the row-, column- and
2-D-sharded ELL paths, SELL shards on several devices from one process
(``shard_sell_rows``), ranks spawned by ``parallel.launch.spawn`` or
``torchrun``, and the device-count sweeps of ``bench.scale``. The
entry programs: ``entry`` (``entry()``, one SELL SpMV step, and
``dryrun_multichip(n)``, one step of every sharded path on n ranks) and
``demo`` (every kernel tier on one matrix, validated), each runnable with
``python -m``. ``SellMatrix`` as exported here converts a matrix whose row
lengths are heavy-tailed (a power-law graph) as SELL-C-sigma by itself
(``formats/sell_order.py``), and its device container still returns y in
the caller's row order. It never imports JAX.
"""

from .bench.harness import run_matrix
from .bench.scale import (run_device_scale_sweep, run_ladder_sweep,
                          run_path_scale_sweep, run_spmm_device_scale_sweep)
from .formats.bsr import BSRMatrix
from .formats.coo import COOMatrix
from .formats.csr import CSRMatrix
from .formats.hll import DEFAULT_HACK_SIZE, HLLMatrix
from .formats.pr import PanelPRMatrix, PRMatrix, pr_from_csr
from .formats.sell import PanelSellMatrix
from .formats.sell_order import SellMatrix
from .formats.split import SplitMatrix
from .io.mmio import (MMIOError, MMTypeCode, read_banner,
                      read_matrix_market, write_matrix_market)
from .ops.auto import AutoOp, auto_device_op, choose_format
from .ops.bsr import DeviceBSR, bsr_spmm, device_put_bsr, pad_rhs
from .ops.hll import hll_to_sell
from .ops.pr import device_put_pr, pr_spmv
from .ops.pr_dd import device_put_pr_dd, pr_spmv_dd
from .ops.sell import (device_put_sell, device_put_x, panel_sell_spmv,
                       sell_spmv)
from .ops.sell_dd import (device_put_sell_dd, device_put_x_dd,
                          panel_sell_spmv_dd, sell_spmv_dd, sell_spmv_dd_f64)
from .ops.sell_spmm import (MAX_RHS, device_put_x_multi, pack_x_multi,
                            sell_spmm)
from .ops.split import (device_put_split, device_put_split_dd, split_spmv,
                        split_spmv_dd)
from .ops.xla import device_put_csr, device_put_ell
from .parallel.multidevice import MultiDeviceSell, shard_sell_rows
from .parallel.scheduler import balanced_partition
from .parallel.sharding import (col_sharded_spmv, make_mesh,
                                row_sharded_spmv, shard_ell_2d,
                                shard_ell_rows, sharded_spmv_2d)
from .parallel.spmd_bsr import bsr_spmm_spmd, shard_bsr
from .parallel.spmd_colsell import build_spmd_sell_cols, sell_spmv_spmd_cols
from .parallel.spmd_pallas import (build_spmd_sell, sell_spmm_spmd,
                                   sell_spmv_spmd)
from .parallel.spmd_pr import build_spmd_pr, pr_spmv_spmd
from .parallel.spmd_split import build_spmd_split, split_spmv_spmd
from .solvers import (GraphedPageRank, bicgstab, cg, cg_multi, cg_sell,
                      chebyshev_preconditioner, chebyshev_smooth,
                      gershgorin_bounds, gmres, iterative_refinement,
                      jacobi_preconditioner, lanczos, lanczos_bounds,
                      lanczos_extremal, pagerank, pagerank_operator,
                      power_iteration, subspace_iteration)
from .tune.autotune import autotune_hack_size, autotune_sell
from .utils.profiling import annotate, profile_trace

__version__ = "0.1.0"

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "SellMatrix",
    "PanelSellMatrix",
    "device_put_sell",
    "device_put_x",
    "sell_spmv",
    "panel_sell_spmv",
    "device_put_sell_dd",
    "device_put_x_dd",
    "sell_spmv_dd",
    "panel_sell_spmv_dd",
    "sell_spmv_dd_f64",
    "PRMatrix",
    "PanelPRMatrix",
    "pr_from_csr",
    "device_put_pr",
    "pr_spmv",
    "device_put_pr_dd",
    "pr_spmv_dd",
    "SplitMatrix",
    "device_put_split",
    "split_spmv",
    "device_put_split_dd",
    "split_spmv_dd",
    "choose_format",
    "auto_device_op",
    "AutoOp",
    "MAX_RHS",
    "pack_x_multi",
    "device_put_x_multi",
    "sell_spmm",
    "BSRMatrix",
    "DeviceBSR",
    "device_put_bsr",
    "pad_rhs",
    "bsr_spmm",
    "HLLMatrix",
    "DEFAULT_HACK_SIZE",
    "hll_to_sell",
    "MMIOError",
    "MMTypeCode",
    "read_banner",
    "read_matrix_market",
    "write_matrix_market",
    "device_put_csr",
    "device_put_ell",
    "run_matrix",
    "run_ladder_sweep",
    "run_device_scale_sweep",
    "run_path_scale_sweep",
    "run_spmm_device_scale_sweep",
    "balanced_partition",
    "make_mesh",
    "shard_ell_rows",
    "row_sharded_spmv",
    "shard_ell_2d",
    "sharded_spmv_2d",
    "col_sharded_spmv",
    "MultiDeviceSell",
    "shard_sell_rows",
    "build_spmd_sell",
    "sell_spmv_spmd",
    "sell_spmm_spmd",
    "shard_bsr",
    "bsr_spmm_spmd",
    "build_spmd_pr",
    "pr_spmv_spmd",
    "build_spmd_split",
    "split_spmv_spmd",
    "build_spmd_sell_cols",
    "sell_spmv_spmd_cols",
    "autotune_sell",
    "autotune_hack_size",
    "profile_trace",
    "annotate",
    "cg",
    "cg_multi",
    "cg_sell",
    "jacobi_preconditioner",
    "bicgstab",
    "gmres",
    "power_iteration",
    "pagerank",
    "GraphedPageRank",
    "pagerank_operator",
    "iterative_refinement",
    "subspace_iteration",
    "chebyshev_preconditioner",
    "chebyshev_smooth",
    "gershgorin_bounds",
    "lanczos",
    "lanczos_extremal",
    "lanczos_bounds",
    "__version__",
]
