"""Block-sparse (128x128 BSR) SpMM in PyTorch: ``Y = A @ X``.

Counterpart of the JAX package's ``ops/pallas_bsr.py``. Its two TPU kernels
differ in how the X slab of a block reaches fast memory, and each has a
route of ``csrc/bsr.cu``:

* ``_kernel`` (BlockSpec index map) -> ``route="blockspec"``,
  :func:`bsr_blockspec`: tiles loaded by TMA into a ring of stages;
* ``_kernel_dma`` (``make_async_copy``) -> ``route="dma"``, :func:`bsr_dma`:
  the same ring filled with ``cp.async``.

Both take f32 or bf16 blocks with X of the same type and sum in f32: f32
with IEEE FFMA (no TF32), bf16 on the tensor cores (``mma.sync``, f32
accumulation). The upload adds ``tile_mask``, one 64-bit mask a slot whose
bit ``8a + b`` says that the block's 16x16 sub-tile ``(a, b)`` holds a
nonzero; the kernels skip the others (:func:`tile_masks`).

:func:`bsr_spmm_plain` is the plain PyTorch version: X slabs gathered by
block column, ``torch.bmm`` with the blocks widened to f32, a sum over the
kb slots. A wrapper given CUDA tensors launches its kernel, or
raises; given CPU tensors it runs the plain version. Each wrapper counts
its launches in ``.launches``.

The JAX package's upload guard (a TPU worker's crash bound) and its split
of X into separate calls of at most 512 columns (a VMEM bound) have no
counterpart: one launch covers every column of X.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.bsr import BLOCK, BSRMatrix
from . import _build
from .sell_spmm import _check_rows_view

__all__ = ["DeviceBSR", "device_put_bsr", "tile_masks", "pad_rhs",
           "bsr_spmm", "bsr_spmm_plain", "bsr_blockspec", "bsr_dma",
           "ROUTES"]

_VALUE_TYPES = (torch.float32, torch.bfloat16)
_X_ALIGN = 8            # X row strides: whole 16-byte chunks of f32 and bf16
_Y_ALIGN = 4            # Y row strides: whole float4s
_PLAIN_ELEMS = 1 << 25  # block products per chunk of the plain version


@dataclass
class DeviceBSR:
    nrows: int
    ncols: int
    nnz: int
    kb: int
    n_block_rows: int
    block_cols: torch.Tensor  # (n_block_rows * kb,) int32
    blocks: torch.Tensor      # (n_block_rows * kb, 128, 128) f32 | bf16
    tile_mask: torch.Tensor   # (n_block_rows * kb,) int64, see tile_masks

    @property
    def n_block_cols(self) -> int:
        return -(-max(self.ncols, 1) // BLOCK)


def device_put_bsr(bsr: BSRMatrix, dtype=torch.float32, *,
                   device) -> DeviceBSR:
    """Upload a host :class:`BSRMatrix` (this package's or the JAX
    package's) with ``dtype`` blocks (f32 blocks round to bf16 on the
    device, as the JAX upload rounds them)."""
    if dtype not in _VALUE_TYPES:
        raise ValueError(f"block dtype {dtype} not supported "
                         "(torch.float32 or torch.bfloat16)")
    blocks = torch.from_numpy(np.ascontiguousarray(bsr.blocks)).to(device) \
        .to(dtype)
    return DeviceBSR(
        int(bsr.nrows), int(bsr.ncols), int(bsr.nnz), int(bsr.kb),
        int(bsr.n_block_rows),
        torch.from_numpy(np.ascontiguousarray(bsr.block_cols, np.int32))
        .to(device), blocks, tile_masks(blocks))


_TILE = 16
# bit weights of the 64 sub-tiles; bit 63 is int64's sign
_BIT_WEIGHTS = [1 << s for s in range(63)] + [-(1 << 63)]


def tile_masks(blocks: torch.Tensor) -> torch.Tensor:
    """``(n, 128, 128)`` blocks -> ``(n,)`` int64 masks on their device:
    bit ``8a + b`` is set iff ``blocks[i, 16a:16a+16, 16b:16b+16]`` holds a
    nonzero. An all-zero (pad) block has mask 0."""
    n, t = blocks.shape[0], BLOCK // _TILE
    live = (blocks.view(n, t, _TILE, t, _TILE) != 0).any(4).any(2)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64,
                           device=blocks.device)
    return (live.view(n, t * t).long() * weights).sum(1)


def pad_rhs(X, ncols: int, dtype=torch.float32, *, device) -> torch.Tensor:
    """The RHS block padded with zeros to ``(n_block_cols*128, B rounded up
    to 128)`` in ``dtype`` on ``device`` (the JAX ``pad_rhs`` with
    ``to_device=False``, there a numpy array). A vector is one column."""
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    rp = -(-max(ncols, 1) // BLOCK) * BLOCK
    bp = -(-X.shape[1] // BLOCK) * BLOCK
    out = torch.zeros(rp, bp, dtype=dtype)
    # narrowed straight from X's type, as numpy's astype does
    out[:X.shape[0], :X.shape[1]] = torch.from_numpy(
        np.ascontiguousarray(X)).to(dtype)
    return out.to(device)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _plain_rows(dbsr: DeviceBSR, xp: torch.Tensor) -> torch.Tensor:
    """``(n_block_rows*128, B)`` f32: each block row's slots times their X
    slabs, summed over the kb slots; a few block rows at a time."""
    kb, n_br, b = dbsr.kb, dbsr.n_block_rows, xp.shape[1]
    slabs = xp.view(-1, BLOCK, b)
    out = torch.empty(n_br * BLOCK, b, dtype=torch.float32, device=xp.device)
    step = max(1, _PLAIN_ELEMS // (kb * BLOCK * max(b, 1)))
    for g0 in range(0, n_br, step):
        g1 = min(n_br, g0 + step)
        s0, s1 = g0 * kb, g1 * kb
        prod = torch.bmm(dbsr.blocks[s0:s1].float(),
                         slabs[dbsr.block_cols[s0:s1].long()].float())
        out[g0 * BLOCK:g1 * BLOCK] = prod.view(g1 - g0, kb, BLOCK, b) \
            .sum(1).view(-1, b)
    return out


# ---------------------------------------------------------------------------
# wrappers: CUDA tensors launch the kernel, CPU tensors run the plain version
# ---------------------------------------------------------------------------


def _check_launch(dbsr: DeviceBSR, xp: torch.Tensor, y: torch.Tensor):
    device = xp.device
    if device.type != "cuda":
        raise RuntimeError(
            f"BSR kernels run on CUDA or CPU tensors, not {device}")
    for name, t in (("block_cols", dbsr.block_cols), ("blocks", dbsr.blocks),
                    ("y", y)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    n_slots = dbsr.n_block_rows * dbsr.kb
    mask = dbsr.tile_mask
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.int64 or \
            not mask.is_contiguous() or tuple(mask.shape) != (n_slots,):
        raise ValueError(f"tile_mask must be {n_slots} contiguous int64 "
                         f"(device_put_bsr's)")
    if mask.device != device:
        raise ValueError(f"tile_mask is on {mask.device}, x on {device}")
    if dbsr.block_cols.dtype != torch.int32 or not \
            dbsr.block_cols.is_contiguous() or \
            dbsr.block_cols.numel() != n_slots:
        raise ValueError(f"block_cols must be {n_slots} contiguous int32")
    if dbsr.blocks.dtype not in _VALUE_TYPES or not \
            dbsr.blocks.is_contiguous() or \
            tuple(dbsr.blocks.shape) != (n_slots, BLOCK, BLOCK):
        raise ValueError(f"blocks must be contiguous ({n_slots}, 128, 128) "
                         f"float32 or bfloat16")
    b = xp.shape[1] if xp.ndim == 2 else 0
    if b < 1:
        raise ValueError(f"x must be (rows, B) with B >= 1, got "
                         f"{tuple(xp.shape)}")
    _check_rows_view(xp, "x", (dbsr.n_block_cols * BLOCK, b),
                     (dbsr.blocks.dtype,), _X_ALIGN)
    _check_rows_view(y, "y", (dbsr.n_block_rows * BLOCK, b), (torch.float32,),
                     _Y_ALIGN)


def _run(wrapper, route: str, dbsr: DeviceBSR, xp: torch.Tensor,
         y: torch.Tensor):
    if xp.device.type == "cpu":
        y.copy_(_plain_rows(dbsr, xp))
        return
    _check_launch(dbsr, xp, y)
    tag = "bf16" if dbsr.blocks.dtype == torch.bfloat16 else "f32"
    name = f"bsr_spmm_{route}_{tag}"
    with torch.cuda.device(xp.device):
        fn = getattr(_build.load(), name)
        err = fn(dbsr.block_cols.data_ptr(), dbsr.tile_mask.data_ptr(),
                 dbsr.blocks.data_ptr(), xp.data_ptr(), y.data_ptr(),
                 dbsr.n_block_rows, dbsr.n_block_cols, dbsr.kb, xp.shape[1],
                 xp.stride(0), y.stride(0),
                 torch.cuda.current_stream(xp.device).cuda_stream)
    if err == -1:
        raise RuntimeError(f"{name}: the TMA tensor maps could not be "
                           "encoded (cuTensorMapEncodeTiled)")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1


def bsr_blockspec(dbsr: DeviceBSR, xp: torch.Tensor, y: torch.Tensor):
    """Write ``Y = A @ X`` into ``y`` (``(n_block_rows*128, B)`` f32) with
    the blockspec kernel. ``xp`` is ``(n_block_cols*128, B)`` in the blocks'
    type; on CUDA both are views of row-major buffers whose row strides are
    multiples of 8 (x) and 4 (y) elements."""
    _run(bsr_blockspec, "blockspec", dbsr, xp, y)


def bsr_dma(dbsr: DeviceBSR, xp: torch.Tensor, y: torch.Tensor):
    """:func:`bsr_blockspec` through the dma (``cp.async``) kernel."""
    _run(bsr_dma, "dma", dbsr, xp, y)


ROUTES = {"blockspec": bsr_blockspec, "dma": bsr_dma}
for _w in ROUTES.values():
    _w.launches = 0


def _x_operand(dbsr: DeviceBSR, X: torch.Tensor) -> torch.Tensor:
    """X as the kernels take it: itself when it already is, else a zeroed
    copy in the blocks' type, padded to ``n_block_cols*128`` rows, with a
    row stride rounded up to 8."""
    rp = dbsr.n_block_cols * BLOCK
    if X.ndim != 2 or X.shape[0] > rp:
        raise ValueError(f"X must be (N, B) or (N,) with N <= {rp}, got "
                         f"{tuple(X.shape)}")
    b = X.shape[1]
    ld = X.stride(0)
    if (X.dtype == dbsr.blocks.dtype and X.shape[0] == rp
            and X.stride(1) == 1 and ld % _X_ALIGN == 0 and ld >= b
            and X.data_ptr() % 16 == 0):
        return X
    buf = torch.zeros(rp, -(-b // _X_ALIGN) * _X_ALIGN,
                      dtype=dbsr.blocks.dtype, device=X.device)
    buf[:X.shape[0], :b] = X
    return buf[:, :b]


def _spmm(dbsr: DeviceBSR, X: torch.Tensor, run) -> torch.Tensor:
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
    xp = _x_operand(dbsr, X)
    b = xp.shape[1]
    y = torch.empty(dbsr.n_block_rows * BLOCK, -(-b // _Y_ALIGN) * _Y_ALIGN,
                    dtype=torch.float32, device=xp.device)[:, :b]
    run(dbsr, xp, y)
    y = y[:dbsr.nrows]
    return y[:, 0] if squeeze else y


def bsr_spmm(dbsr: DeviceBSR, X: torch.Tensor, *,
             route: str = "blockspec") -> torch.Tensor:
    """``Y = A @ X``; returns ``(nrows, B)`` f32 (``(nrows,)`` for a 1-D X).

    ``X`` is the padded table of :func:`pad_rhs` (used as it is) or any
    ``(ncols, B)`` / ``(ncols,)`` tensor (copied into the kernels' layout in
    the blocks' type). ``route`` picks the kernel: ``"blockspec"`` or
    ``"dma"``. CUDA tensors launch it, CPU tensors run the plain version."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are "
                         f"{', '.join(ROUTES)}")
    return _spmm(dbsr, X, ROUTES[route])


def bsr_spmm_plain(dbsr: DeviceBSR, X: torch.Tensor) -> torch.Tensor:
    """:func:`bsr_spmm` through the plain version on any device — the
    reference the kernels are held against."""
    return _spmm(dbsr, X, lambda d, xp, y: y.copy_(_plain_rows(d, xp)))
