"""sparsematrixvectormultiplication_tpu_torch — SELL SpMV on PyTorch and CUDA.

The port of ``sparsematrixvectormultiplication_tpu`` (JAX/Pallas, the
reference) to PyTorch with hand-written CUDA kernels for NVIDIA Hopper
(``sm_90a``). It carries its own numpy copies of the host layers (Matrix
Market IO, COO/CSR/SELL conversion, synthetic matrices, validation) and runs
SELL SpMV on every bin layout (k-major, window-layered, sb-major, sb-list,
sg) and over column panels, f32 or bf16 values with f32 x and sums, or
fp64-class double-double values, x and sums. It never imports JAX.
"""

from .bench.harness import run_matrix
from .formats.coo import COOMatrix
from .formats.csr import CSRMatrix
from .formats.sell import PanelSellMatrix, SellMatrix
from .ops.sell import (device_put_sell, device_put_x, panel_sell_spmv,
                       sell_spmv)
from .ops.sell_dd import (device_put_sell_dd, device_put_x_dd,
                          panel_sell_spmv_dd, sell_spmv_dd, sell_spmv_dd_f64)

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
    "run_matrix",
    "__version__",
]
