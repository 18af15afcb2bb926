"""The generated matrix, and the counter-based hash behind its values."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_M64 = 1 << 64


def _signed(c: int) -> int:
    return c - _M64 if c >= 1 << 63 else c


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` by ``s`` bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finaliser on int64 tensors, bit for bit the uint64 one:
    int64 addition and multiplication wrap modulo 2**64 on the CPU and on
    the card alike."""
    z = z + _GOLDEN
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def uniform_of(key: torch.Tensor, salt: int) -> torch.Tensor:
    """A float64 in [-1, 1) for each int64 ``key``, a function of the key
    and ``salt`` alone: equal keys give equal values."""
    z = splitmix64(key ^ _signed(salt % _M64))
    return _srl(z, 11).to(torch.float64) * (2.0 ** -52) - 1.0


@dataclass
class Matrix:
    """A sparse matrix in coordinate form: int64 ``row``/``col`` and
    float64 ``val`` tensors on one device, no duplicate coordinates."""

    nrows: int
    ncols: int
    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor

    @property
    def nnz(self) -> int:
        return int(self.row.numel())

    def to(self, device) -> "Matrix":
        return Matrix(self.nrows, self.ncols, self.row.to(device),
                      self.col.to(device), self.val.to(device))

    def numpy(self) -> tuple:
        """``(row, col, val)`` as int32, int32 and float64 numpy arrays."""
        return (self.row.to(torch.int32).cpu().numpy(),
                self.col.to(torch.int32).cpu().numpy(),
                self.val.cpu().numpy())

    @classmethod
    def from_numpy(cls, nrows: int, ncols: int, row: np.ndarray,
                   col: np.ndarray, val: np.ndarray, device) -> "Matrix":
        return cls(nrows, ncols,
                   torch.from_numpy(np.asarray(row)).to(device, torch.int64),
                   torch.from_numpy(np.asarray(col)).to(device, torch.int64),
                   torch.from_numpy(np.asarray(val)).to(device,
                                                        torch.float64))
