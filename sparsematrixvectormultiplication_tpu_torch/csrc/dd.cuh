// Double-double (two-float) arithmetic as device code.
//
// The device twin of ops/doubledouble.py (and of the JAX package's
// ops/doubledouble.py): a value is an unevaluated pair of floats (hi, lo)
// with hi + lo the fp64-class value. The error-free transforms hold only if
// every add, subtract and multiply rounds on its own. nvcc contracts a
// multiply followed by an add into one FMA by default (-fmad=true), and
// would, for instance, fold the c - (c - a) of a Dekker split. So every
// operation here is a round-to-nearest intrinsic (__fadd_rn, __fsub_rn,
// __fmul_rn), which nvcc never contracts, and two_prod takes its error term
// from one explicit FMA, which is exact: p + e == a * b.

#pragma once

namespace dd {

// Knuth two-sum: s + e == a + b exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// Dekker fast-two-sum: s + e == a + b exactly when |a| >= |b|.
__device__ __forceinline__ void fast_two_sum(float a, float b, float& s,
                                             float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// p + e == a * b exactly.
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

// (xh, xl) += (yh, yl), normalized.
__device__ __forceinline__ void add_dd(float& xh, float& xl, float yh,
                                       float yl) {
  float sh, se;
  two_sum(xh, yh, sh, se);
  const float te = __fadd_rn(se, __fadd_rn(xl, yl));
  fast_two_sum(sh, te, xh, xl);
}

// (ph, pl) = (xh, xl) * (yh, yl), normalized; drops the xl*yl term.
__device__ __forceinline__ void mul_dd(float xh, float xl, float yh, float yl,
                                       float& ph, float& pl) {
  float p, e;
  two_prod(xh, yh, p, e);
  const float cross = __fadd_rn(__fmul_rn(xh, yl), __fmul_rn(xl, yh));
  fast_two_sum(p, __fadd_rn(e, cross), ph, pl);
}

}  // namespace dd
