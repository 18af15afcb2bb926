// Shared geometry and sum policies of the SELL-C-128 SpMV kernels.
//
// A group is 1024 rows: 8 row-blocks of 128 rows. Every kernel here runs one
// block of 128 threads per (group, row-block), or sg one block of 1024 per
// group (or per chunk of a group's tiles), and one thread per output row, so
// thread j of a block reads lane j of every (., 128) plane row: the value
// and index streams coalesce.
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
//     (f32 add, or dd::add_dd of y's pair and the sum), else stored. Its
//     `gather` loads a column's (hi, lo) x pair from the two tables.
// Partial sums of one row are joined by `combine` (one f32 add, or
// dd::add_dd). Kernels that batch their loads load a slot's value apart from
// its add (`load`, then `add(acc, v, col)`):
//   F32Slots<T>: F32Sum's arithmetic;
//   DDPairs: one (hi, lo) float2 value plane and one interleaved (hi, lo)
//     x table, so a slot is one 8-byte value load and one 8-byte gather;
//     DDSum's arithmetic, y still two f32 planes.
//
// The stored-zero rule, the same in every layout and precision: a slot
// whose value is zero (dd: hi and lo both zero), a pad or a stored zero,
// adds nothing to its row. A select on the value replaces the x it gathered
// by 0 before the multiply, so its product is an exact zero and an infinite
// or NaN x at its column never reaches the row; adding the zero leaves the
// row's sum as it was (a sum that starts at +0 is never -0, and a dd sum is
// a normalised pair). The slot's x is still loaded, from the column its
// layout names (always one of the x table's rows): making the gather depend
// on the value load held a batch's gathers apart, the bf16 wl kernel's
// most, and a select on the sum itself lengthened each row's chain of
// dependent adds (PERF.md, PR 11). The upload's compaction drops
// exactly these slots (ops/sell.py), so a compacted layout and a padded one
// compute the same function.
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

// acc = fmaf(w, xv, acc), unless w is zero: then acc + 0*0, acc as it was
__device__ __forceinline__ void fma_unless_zero(float& acc, float w,
                                                float xv) {
  acc = fmaf(w, w != 0.f ? xv : 0.f, acc);
}

template <typename T>
struct F32Sum {
  using Acc = float;
  const T* as;
  const float* x;
  float* y;

  __device__ __forceinline__ Acc zero() const { return 0.f; }
  __device__ __forceinline__ void add(Acc& acc, int64_t off, int col) const {
    fma_unless_zero(acc, widen(__ldg(as + off)), __ldg(x + col));
  }
  __device__ __forceinline__ static Acc combine(Acc a, Acc b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ void store(Acc acc, int64_t row,
                                        int accumulate) const {
    y[row] = accumulate ? y[row] + acc : acc;
  }
};

struct DDSum {
  struct alignas(8) Acc {
    float hi, lo;
  };
  using Val = float2;  // (hi, lo)
  const float* as_hi;
  const float* as_lo;
  const float* x_hi;
  const float* x_lo;
  float* y_hi;
  float* y_lo;

  __device__ __forceinline__ Acc zero() const { return {0.f, 0.f}; }
  // acc += v * (xh, xl), unless v is zero: then acc + (0, 0), acc as it was
  __device__ __forceinline__ static void add_unless_zero(Acc& acc, Val v,
                                                         float xh, float xl) {
    const bool take = v.x != 0.f || v.y != 0.f;
    float ph, pl;
    dd::mul_dd(v.x, v.y, take ? xh : 0.f, take ? xl : 0.f, ph, pl);
    dd::add_dd(acc.hi, acc.lo, ph, pl);
  }
  __device__ __forceinline__ Val load(int64_t off) const {
    return make_float2(__ldg(as_hi + off), __ldg(as_lo + off));
  }
  __device__ __forceinline__ void add(Acc& acc, Val v, int col) const {
    add_unless_zero(acc, v, __ldg(x_hi + col), __ldg(x_lo + col));
  }
  __device__ __forceinline__ void add(Acc& acc, int64_t off, int col) const {
    add(acc, load(off), col);
  }
  using XVal = float2;  // a column's (hi, lo) x
  __device__ __forceinline__ XVal gather(int col) const {
    return make_float2(__ldg(x_hi + col), __ldg(x_lo + col));
  }
  __device__ __forceinline__ void add(Acc& acc, Val v, XVal xv) const {
    add_unless_zero(acc, v, xv.x, xv.y);
  }
  __device__ __forceinline__ static Acc combine(Acc a, Acc b) {
    dd::add_dd(a.hi, a.lo, b.hi, b.lo);
    return a;
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

template <typename T>
struct F32Slots : F32Sum<T> {
  using Val = T;
  using XVal = float;
  using F32Sum<T>::add;
  __device__ __forceinline__ Val load(int64_t off) const {
    return __ldg(this->as + off);
  }
  __device__ __forceinline__ XVal gather(int col) const {
    return __ldg(this->x + col);
  }
  __device__ __forceinline__ void add(float& acc, Val v, XVal xv) const {
    fma_unless_zero(acc, widen(v), xv);
  }
  __device__ __forceinline__ void add(float& acc, Val v, int col) const {
    add(acc, v, gather(col));
  }
};

struct DDPairs : DDSum {
  using XVal = float2;
  const float2* as2;
  const float2* x2;
  __device__ __forceinline__ Val load(int64_t off) const {
    return __ldg(as2 + off);
  }
  __device__ __forceinline__ XVal gather(int col) const {
    return __ldg(x2 + col);
  }
  __device__ __forceinline__ void add(Acc& acc, Val v, XVal xv) const {
    add_unless_zero(acc, v, xv.x, xv.y);
  }
  __device__ __forceinline__ void add(Acc& acc, Val v, int col) const {
    add(acc, v, gather(col));
  }
};

// A row's partial sum from the lane `m` lanes away in the warp (every lane
// of the warp takes part): the lane-split kernels join their sums with it.
__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(~0u, v, m);
}
__device__ __forceinline__ DDSum::Acc shfl_xor(DDSum::Acc v, int m) {
  return {__shfl_xor_sync(~0u, v.hi, m), __shfl_xor_sync(~0u, v.lo, m)};
}

// The row-list kernel of the compacted layouts: sb-list with int32 planes,
// sg in f32 and bf16, and k-major dd bins of one lane a row (ops/sell.py
// `_compact_sl`, `_compact_sg`, `_compact_km`). The
// upload sorts each group's rows by their real length, longest first, keeps
// each row's real slots in the order its layout adds them and gives each 32
// sorted rows a plane as wide as the longest of them: sorted row s = g*1024
// + rank's slot q sits at (plane_off[s/32] + q)*32 + s%32, its absolute
// column in ja, and row_table[s] = (length << 10) | its row within the
// group. One thread per sorted row, one 128-thread block per 128 sorted
// rows: a warp reads 128 contiguous bytes of each plane row, its rows'
// lengths nearly equal, and each thread loads B slots' columns and values
// before it adds them; with kGatherFirst it gathers the batch's x in a pass
// of its own before the adds (sg's long rows and k-major dd's run faster so
// on the H100, sb-list's rows of 1-8 slots slower). Rows are unique within a bin, so the
// scattered y stores need no atomics.
constexpr int kWarp = 32;       // sorted rows sharing one compacted plane
constexpr int kRowBits = 10;    // row_table: (length << 10) | row in group
// slots whose loads a thread keeps in flight, by default: 4 f32 or bf16
// values (fewer registers, more warps an SM), 8 dd pairs (more arithmetic a
// slot)
template <typename Sum>
constexpr int kListBatch = sizeof(typename Sum::Val) >= 8 ? 8 : 4;

template <typename Sum, int B, bool kGatherFirst>
__global__ void __launch_bounds__(kLanes)
row_list_kernel(const int* __restrict__ group_ids,
                const int* __restrict__ plane_off,
                const int* __restrict__ row_table, const int* __restrict__ ja,
                Sum sum, int accumulate) {
  const int64_t s = int64_t(blockIdx.x) * kLanes + threadIdx.x;  // sorted row
  const int t = __ldg(row_table + s);
  const int n = t >> kRowBits;
  int64_t off = int64_t(__ldg(plane_off + s / kWarp)) * kWarp +
                (threadIdx.x & (kWarp - 1));
  typename Sum::Acc acc = sum.zero();
  for (int q0 = 0; q0 < n; q0 += B, off += B * kWarp) {
    int col[B];
    typename Sum::Val v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (q0 + u < n) {
        col[u] = __ldg(ja + off + u * kWarp);
        v[u] = sum.load(off + u * kWarp);
      }
    }
    if constexpr (kGatherFirst) {
      typename Sum::XVal xv[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u < n) xv[u] = sum.gather(col[u]);
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u < n) sum.add(acc, v[u], xv[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u < n) sum.add(acc, v[u], col[u]);
      }
    }
  }
  sum.store(acc,
            int64_t(group_ids[blockIdx.x / kSublanes]) * kGroupRows +
                (t & (kGroupRows - 1)),
            accumulate);
}

template <typename Sum, int B = kListBatch<Sum>, bool kGatherFirst = false>
int launch_row_list(const int* group_ids, const int* plane_off,
                    const int* row_table, const int* ja, Sum sum,
                    int64_t n_groups, int accumulate, void* stream) {
  if (n_groups > 0) {
    row_list_kernel<Sum, B, kGatherFirst>
        <<<dim3(unsigned(n_groups * kSublanes)), kLanes, 0,
           static_cast<cudaStream_t>(stream)>>>(
        group_ids, plane_off, row_table, ja, sum, accumulate);
  }
  return int(cudaGetLastError());
}

}  // namespace sell
