// Shared geometry and sum policies of the SELL-C-128 SpMV kernels.
//
// A group is 1024 rows: 8 row-blocks of 128 rows. Every kernel here runs one
// block of 128 threads per (group, row-block), or sg one block of 1024 per
// group, and one thread per output row, so thread j of a block reads lane j
// of every (., 128) plane row: the value and index streams coalesce.
//
// A kernel decodes each slot of its layout into the slot's plane offset and
// its x column, and hands both to a sum policy, which holds the value, x and
// y pointers, loads the slot's value and x, and adds their product onto the
// row's accumulator. One decode serves both precisions:
//   F32Sum<T>: values T (f32 or bf16), x, sums and y in f32; each slot
//     adds onto the row's sum with one fmaf, in entry order (the SpMM
//     kernels of sell_spmm.cu repeat it, so their columns equal SpMV);
//   DDSum: double-double (hi, lo) f32 planes of values, x and y; each slot's
//     product by dd::mul_dd, the row's sum by dd::add_dd (dd.cuh), which
//     nvcc cannot contract. With `accumulate` the row's sum is added onto y
//     (f32 add, or dd::add_dd of y's pair and the sum), else stored.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace sell {

constexpr int kLanes = 128;                     // rows per row-block
constexpr int kSublanes = 8;                    // row-blocks per group
constexpr int kGroupRows = kLanes * kSublanes;  // 1024

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct F32Sum {
  using Acc = float;
  const T* as;
  const float* x;
  float* y;

  __device__ __forceinline__ Acc zero() const { return 0.f; }
  __device__ __forceinline__ float product(int64_t off, int col) const {
    return widen(__ldg(as + off)) * __ldg(x + col);
  }
  __device__ __forceinline__ void add(Acc& acc, int64_t off, int col) const {
    acc = fmaf(widen(__ldg(as + off)), __ldg(x + col), acc);
  }
  __device__ __forceinline__ void store(Acc acc, int64_t row,
                                        int accumulate) const {
    y[row] = accumulate ? y[row] + acc : acc;
  }
};

struct DDSum {
  struct Acc {
    float hi, lo;
  };
  const float* as_hi;
  const float* as_lo;
  const float* x_hi;
  const float* x_lo;
  float* y_hi;
  float* y_lo;

  __device__ __forceinline__ Acc zero() const { return {0.f, 0.f}; }
  __device__ __forceinline__ void add(Acc& acc, int64_t off, int col) const {
    float ph, pl;
    dd::mul_dd(__ldg(as_hi + off), __ldg(as_lo + off), __ldg(x_hi + col),
               __ldg(x_lo + col), ph, pl);
    dd::add_dd(acc.hi, acc.lo, ph, pl);
  }
  __device__ __forceinline__ void store(Acc acc, int64_t row,
                                        int accumulate) const {
    if (accumulate) {
      float h = y_hi[row], l = y_lo[row];
      dd::add_dd(h, l, acc.hi, acc.lo);
      acc = {h, l};
    }
    y_hi[row] = acc.hi;
    y_lo[row] = acc.lo;
  }
};

}  // namespace sell
