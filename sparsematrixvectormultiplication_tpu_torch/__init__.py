"""sparsematrixvectormultiplication_tpu_torch — SELL SpMV on PyTorch and CUDA.

The port of ``sparsematrixvectormultiplication_tpu`` (JAX/Pallas, the
reference) to PyTorch with hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``). It carries its own numpy copies of the host layers (Matrix
Market IO, COO/CSR/SELL conversion, synthetic matrices, validation) and runs
SELL SpMV on every bin layout (k-major, window-layered, sb-major, sb-list,
sg) and over column panels, f32 or bf16 values with f32 x and sums, or
fp64-class double-double values, x and sums; the scattered regime through
the PR (permutation-routed) layout and the locality split (near SELL plus a
PR far side), f32 and double-double; and ``auto_device_op``, which picks
one of the three layouts. It never imports JAX.
"""

from .bench.harness import run_matrix
from .formats.coo import COOMatrix
from .formats.csr import CSRMatrix
from .formats.pr import PanelPRMatrix, PRMatrix, pr_from_csr
from .formats.sell import PanelSellMatrix, SellMatrix
from .formats.split import SplitMatrix
from .ops.auto import AutoOp, auto_device_op, choose_format
from .ops.pr import device_put_pr, pr_spmv
from .ops.pr_dd import device_put_pr_dd, pr_spmv_dd
from .ops.sell import (device_put_sell, device_put_x, panel_sell_spmv,
                       sell_spmv)
from .ops.sell_dd import (device_put_sell_dd, device_put_x_dd,
                          panel_sell_spmv_dd, sell_spmv_dd, sell_spmv_dd_f64)
from .ops.split import (device_put_split, device_put_split_dd, split_spmv,
                        split_spmv_dd)

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
    "run_matrix",
    "__version__",
]
