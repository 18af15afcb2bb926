"""Double-double (two-float) arithmetic in PyTorch: fp64-class sums from f32.

Counterpart of the JAX package's ``ops/doubledouble.py``. A value is an
unevaluated pair of f32 tensors ``(hi, lo)`` with ``hi + lo`` the fp64-class
value and ``|lo| <= ulp(hi)/2``; error-free transforms (Knuth two-sum,
Dekker two-product) give about 2^-48 relative accuracy.

Every function is a sequence of separate eager elementwise ops, each of which
rounds to f32: no ``addcmul``, ``torch.compile`` or other fusion that could
turn a multiply and an add into one fused multiply-add, which would break
the transforms. The CUDA kernels carry the same functions in ``csrc/dd.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_f64", "combine_f64", "two_sum", "fast_two_sum",
           "two_prod", "dd_add_dd", "dd_mul_dd"]

_SPLITTER = 4097.0  # 2^12 + 1: Dekker split of a 24-bit mantissa


def split_f64(x: np.ndarray):
    """Host-side split of fp64 into (hi, lo) f32 with hi + lo == fp64(x)
    to f32-pair precision (bit-identical to the JAX package's)."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def combine_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The pair back to fp64, on the pair's device."""
    return hi.double() + lo.double()


def two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker fast-two-sum; requires |a| >= |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _dekker_split(a):
    """a == ah + al exactly, each half with at most 12 significant bits."""
    c = a * _SPLITTER
    ah = c - (c - a)
    al = a - ah
    return ah, al


def two_prod(a, b):
    """Dekker two-product: p + err == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = _dekker_split(a)
    bh, bl = _dekker_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd_add_dd(xh, xl, yh, yl):
    """(xh,xl) + (yh,yl) -> normalized dd."""
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    return fast_two_sum(sh, te)


def dd_mul_dd(xh, xl, yh, yl):
    """(xh,xl) * (yh,yl) -> dd (drops the xl*yl term, ~2^-48 accurate)."""
    ph, pe = two_prod(xh, yh)
    pl = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pl)
