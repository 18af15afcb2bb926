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
matvec or matmat with its state on the device. It never imports JAX.
"""

from .bench.harness import run_matrix
from .formats.bsr import BSRMatrix
from .formats.coo import COOMatrix
from .formats.csr import CSRMatrix
from .formats.hll import HLLMatrix
from .formats.pr import PanelPRMatrix, PRMatrix, pr_from_csr
from .formats.sell import PanelSellMatrix, SellMatrix
from .formats.split import SplitMatrix
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
from .solvers import (bicgstab, cg, cg_multi, cg_sell,
                      chebyshev_preconditioner, chebyshev_smooth,
                      gershgorin_bounds, gmres, iterative_refinement,
                      jacobi_preconditioner, lanczos, lanczos_bounds,
                      lanczos_extremal, pagerank, pagerank_operator,
                      power_iteration, subspace_iteration)

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
    "hll_to_sell",
    "device_put_csr",
    "device_put_ell",
    "run_matrix",
    "cg",
    "cg_multi",
    "cg_sell",
    "jacobi_preconditioner",
    "bicgstab",
    "gmres",
    "power_iteration",
    "pagerank",
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
