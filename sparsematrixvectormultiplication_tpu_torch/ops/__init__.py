"""Device SpMV and SpMM: the CUDA kernels' wrappers (CUDA tensors launch
the kernels, CPU tensors run their plain versions), the double-double
fp64-class variants and the plain PyTorch CSR/ELL twins. Importing this
package compiles nothing: ``_build.load`` builds the kernels at first
launch.

The SELL SpMM function is not re-exported here: ``sell_spmm`` names its
module (``ops.sell_spmm.sell_spmm``; the package's top level exports the
function)."""

from .auto import AutoOp, auto_device_op, choose_format
from .bsr import DeviceBSR, bsr_spmm, device_put_bsr, pad_rhs
from .hll import hll_to_sell
from .pr import DevicePR, DevicePanelPR, device_put_pr, pr_spmv
from .pr_dd import DevicePRDD, device_put_pr_dd, pr_spmv_dd
from .sell import (DevicePanelSell, DeviceSell, DeviceSellBin,
                   device_put_sell, device_put_x, pack_x_table,
                   panel_sell_spmv, sell_spmv)
from .sell_dd import (DeviceSellDD, device_put_sell_dd, device_put_x_dd,
                      panel_sell_spmv_dd, sell_spmv_dd, sell_spmv_dd_f64)
from .sell_spmm import MAX_RHS, device_put_x_multi, pack_x_multi
from .split import (DeviceSplit, DeviceSplitDD, device_put_split,
                    device_put_split_dd, split_spmv, split_spmv_dd)
from .xla import (DeviceCSR, DeviceELL, csr_spmm, csr_spmv, device_put_csr,
                  device_put_ell, ell_spmv, sell_spmv_xla)

__all__ = [
    "AutoOp", "auto_device_op", "choose_format",
    "DeviceBSR", "bsr_spmm", "device_put_bsr", "pad_rhs",
    "hll_to_sell",
    "DevicePR", "DevicePanelPR", "device_put_pr", "pr_spmv",
    "DevicePRDD", "device_put_pr_dd", "pr_spmv_dd",
    "DevicePanelSell", "DeviceSell", "DeviceSellBin", "device_put_sell",
    "device_put_x", "pack_x_table", "panel_sell_spmv", "sell_spmv",
    "DeviceSellDD", "device_put_sell_dd", "device_put_x_dd",
    "panel_sell_spmv_dd", "sell_spmv_dd", "sell_spmv_dd_f64",
    "MAX_RHS", "device_put_x_multi", "pack_x_multi",
    "DeviceSplit", "DeviceSplitDD", "device_put_split", "device_put_split_dd",
    "split_spmv", "split_spmv_dd",
    "DeviceCSR", "DeviceELL", "csr_spmm", "csr_spmv", "device_put_csr",
    "device_put_ell", "ell_spmv", "sell_spmv_xla",
]
