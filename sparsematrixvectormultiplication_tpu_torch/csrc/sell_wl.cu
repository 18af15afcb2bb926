// Window-layered (wl) SELL-C-128 SpMV on Hopper, f32 and double-double.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_wl` and ops/pallas_sell_dd.py `_kernel_wl_dd` (packed index
// plane). Layout of one bin group g, with NW windows of 8 slab slots per
// row-block and L layer tiles per window:
//   tile t = (rb*NW + w)*L + l of the group, for row-block rb < 8, w < NW, l < L;
//   value of slot s < 8, row rb*128+j: as[(g*Tn + t)*8 + s, j], Tn = 8*NW*L;
//   lane index m: byte t%4 of packed[(g*Tp + t/4)*8 + s, j], Tp = ceil(Tn/4);
//   slab of (rb, w, s): slabs[g, (rb*NW + w)*8 + s]; pad slots name the spare
//   all-zero slab, so x must be padded to slab_table_rows(ncols)*128;
//   y[gid*1024 + rb*128 + j] = sum over w, l, s of as * x[128*slab + m].
// The TPU kernel built an 8-row window table and lane-gathered it once per
// tile; a GPU thread gathers x[128*slab + m] directly.
//
// What bounds it on an H100: bytes. Every padded slot streams its value
// (4 B f32, 2 B bf16, 8 B dd) and one byte of packed lane index; x is re-read
// through L1/L2. The fem3d_cube matrix (fem_3d(60,60,60,dof=3)) has 92.3M
// padded wl slots: 0.46 GB per SpMV with f32 values, 0.28 GB with bf16, 0.83
// GB dd. Design: one thread per row, one 128-thread block per (group,
// row-block). The block's NW*8 slab ids are uniform across its threads, so
// they are read once into shared memory as x offsets. Each packed index word
// is read once per tile (four times per word, the repeats hit L1). Sums are
// f32 whatever the value type, or dd pairs; y is written with a plain store,
// or added onto with `accumulate` (column panels); rows within a bin are
// unique, so neither needs atomics.

#include "sell_common.cuh"

namespace sell {

template <typename Sum>
__global__ void __launch_bounds__(kLanes)
wl_kernel(const int* __restrict__ group_ids, const int* __restrict__ slabs,
          const int* __restrict__ packed, Sum sum, int NW, int L,
          int accumulate) {
  extern __shared__ int x_base[];  // NW*8 slot offsets 128*slab into x
  const int64_t g = blockIdx.x / kSublanes;
  const int rb = blockIdx.x % kSublanes;
  const int j = threadIdx.x;
  const int nslot = NW * 8;
  const int* block_slabs = slabs + (g * kSublanes + rb) * nslot;
  for (int q = j; q < nslot; q += kLanes) x_base[q] = block_slabs[q] * kLanes;
  __syncthreads();

  const int Tn = kSublanes * NW * L;
  const int Tp = (Tn + 3) / 4;
  const int64_t vals = g * Tn * 8 * kLanes + j;  // plane offset of tile 0
  const int* idx = packed + g * Tp * 8 * kLanes + j;
  typename Sum::Acc acc = sum.zero();
  int t = rb * NW * L;
  for (int w = 0; w < NW; ++w) {
    const int* wbase = x_base + w * 8;
    for (int l = 0; l < L; ++l, ++t) {
      const int shift = 8 * (t & 3);
      const int64_t vt = vals + int64_t(t) * 8 * kLanes;
      const int* it = idx + int64_t(t >> 2) * 8 * kLanes;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int m = (it[s * kLanes] >> shift) & (kLanes - 1);
        sum.add(acc, vt + s * kLanes, wbase[s] + m);
      }
    }
  }
  sum.store(acc, int64_t(group_ids[g]) * kGroupRows + rb * kLanes + j,
            accumulate);
}

template <typename Sum>
int launch_wl(const int* group_ids, const int* slabs, const int* packed,
              Sum sum, int64_t n_groups, int NW, int L, int accumulate,
              void* stream) {
  if (n_groups > 0) {
    wl_kernel<Sum><<<dim3(unsigned(n_groups * kSublanes)), kLanes,
                     size_t(NW) * 8 * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
        group_ids, slabs, packed, sum, NW, L, accumulate);
  }
  return int(cudaGetLastError());
}

}  // namespace sell

extern "C" int sell_wl_f32(const int* group_ids, const int* slabs,
                           const int* packed, const float* as, const float* x,
                           float* y, int64_t n_groups, int NW, int L,
                           int accumulate, void* stream) {
  return sell::launch_wl(group_ids, slabs, packed,
                         sell::F32Sum<float>{as, x, y}, n_groups, NW, L,
                         accumulate, stream);
}

extern "C" int sell_wl_bf16(const int* group_ids, const int* slabs,
                            const int* packed, const __nv_bfloat16* as,
                            const float* x, float* y, int64_t n_groups, int NW,
                            int L, int accumulate, void* stream) {
  return sell::launch_wl(group_ids, slabs, packed,
                         sell::F32Sum<__nv_bfloat16>{as, x, y}, n_groups, NW,
                         L, accumulate, stream);
}

extern "C" int sell_wl_dd(const int* group_ids, const int* slabs,
                          const int* packed, const float* as_hi,
                          const float* as_lo, const float* x_hi,
                          const float* x_lo, float* y_hi, float* y_lo,
                          int64_t n_groups, int NW, int L, int accumulate,
                          void* stream) {
  return sell::launch_wl(group_ids, slabs, packed,
                         sell::DDSum{as_hi, as_lo, x_hi, x_lo, y_hi, y_lo},
                         n_groups, NW, L, accumulate, stream);
}
