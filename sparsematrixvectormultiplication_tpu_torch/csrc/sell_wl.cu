// Window-layered (wl) SELL-C-128 SpMV on Hopper over compacted planes, f32,
// bf16 and double-double.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/pallas_sell.py
// `_kernel_wl` and ops/pallas_sell_dd.py `_kernel_wl_dd`. The host layout of
// one bin group g, with NW windows of 8 slab slots per row-block and L layer
// tiles per window: tile t = (rb*NW + w)*L + l, slot s < 8 of tile t holds,
// for row rb*128 + j, a value and a lane index m; its column is
// 128*slabs[g, (rb*NW + w)*8 + s] + m. Every row has NW*L*8 slots, and a
// slot serves its lane's row whether that row has an entry there or not.
//
// The upload (ops/sell.py:_compact_wl) keeps only the slots whose value is
// not zero, row by row, in the order (w, l, s) in which the TPU kernel and
// the previous padded kernel added them:
//   block b = g*8 + rb owns plane rows [plane_off[b], plane_off[b + 1]), as
//   many as its longest row has real slots; slot q < row_len[b*128 + j] of
//   row rb*128 + j sits at (plane_off[b] + q)*128 + j, as its value and a
//   2-byte code ((w*8 + s) << 7) | m, so its column is
//   128*slabs[b*NW*8 + (code >> 7)] + (code & 127);
//   y[gid*1024 + rb*128 + j] = sum over q < row_len, in q order.
// A dropped slot is one the stored-zero rule of sell_common.cuh discards (a
// zero value adds nothing), so y equals the padded layout's
// under that rule bit for bit; on finite x it is also the sum over every
// padded slot, up to the sign of a zero sum: fmaf(0, x, acc) == acc, and
// dd::add_dd of (0, 0) leaves a normalised pair as it is.
//
// What bounds it on an H100: bytes. A slot streams its value (f32 4 B, bf16
// 2, dd one 8-byte (hi, lo) pair) and its 2-byte code, coalesced (thread j
// reads lane j of each 128-slot row), and gathers x through L1/L2 (dd: one
// 8-byte (hi, lo) pair from the interleaved table). The headline
// fem_3d(60,60,60,dof=3) has 50.8M entries in 92.3M padded wl slots; the
// compacted planes hold about 1.015x the entries. Design: one thread per
// row, one 128-thread block per (group, row-block); the block's NW*8 slab
// ids are read once into shared memory as x offsets; each thread loads the
// codes and values of kBatch slots before it adds them, in order, so it has
// up to 2*kBatch loads in flight. Sums are f32 (one fmaf a slot, bf16
// widened) or dd pairs; y is stored, or added onto with `accumulate`
// (column panels); rows within a bin are unique, so neither needs atomics.

#include "sell_common.cuh"

namespace sell {

constexpr int kBatch = 8;  // slots whose loads are in flight together

template <typename Sum>
__global__ void __launch_bounds__(kLanes)
wl_kernel(const int* __restrict__ group_ids, const int* __restrict__ slabs,
          const int* __restrict__ plane_off, const int* __restrict__ row_len,
          const int16_t* __restrict__ codes, Sum sum, int NW,
          int accumulate) {
  extern __shared__ int x_base[];  // NW*8 slot offsets 128*slab into x
  const int b = blockIdx.x;        // g*8 + rb
  const int j = threadIdx.x;
  const int nslot = NW * 8;
  const int* block_slabs = slabs + int64_t(b) * nslot;
  for (int q = j; q < nslot; q += kLanes) {
    x_base[q] = __ldg(block_slabs + q) * kLanes;
  }
  __syncthreads();

  const int n = __ldg(row_len + int64_t(b) * kLanes + j);
  int64_t off = int64_t(__ldg(plane_off + b)) * kLanes + j;
  typename Sum::Acc acc = sum.zero();
  for (int q0 = 0; q0 < n; q0 += kBatch, off += kBatch * kLanes) {
    int col[kBatch];
    typename Sum::Val v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (q0 + u < n) {
        const int c = __ldg(codes + off + u * kLanes);
        col[u] = x_base[c >> 7] + (c & (kLanes - 1));
        v[u] = sum.load(off + u * kLanes);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (q0 + u < n) sum.add(acc, v[u], col[u]);
    }
  }
  sum.store(acc,
            int64_t(group_ids[b / kSublanes]) * kGroupRows +
                (b % kSublanes) * kLanes + j,
            accumulate);
}

template <typename Sum>
int launch_wl(const int* group_ids, const int* slabs, const int* plane_off,
              const int* row_len, const int16_t* codes, Sum sum,
              int64_t n_groups, int NW, int accumulate, void* stream) {
  if (n_groups > 0) {
    wl_kernel<Sum><<<dim3(unsigned(n_groups * kSublanes)), kLanes,
                     size_t(NW) * 8 * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
        group_ids, slabs, plane_off, row_len, codes, sum, NW, accumulate);
  }
  return int(cudaGetLastError());
}

}  // namespace sell

extern "C" int sell_wl_f32(const int* group_ids, const int* slabs,
                           const int* plane_off, const int* row_len,
                           const int16_t* codes, const float* as,
                           const float* x, float* y, int64_t n_groups, int NW,
                           int accumulate, void* stream) {
  return sell::launch_wl(group_ids, slabs, plane_off, row_len, codes,
                         sell::F32Slots<float>{{as, x, y}}, n_groups, NW,
                         accumulate, stream);
}

extern "C" int sell_wl_bf16(const int* group_ids, const int* slabs,
                            const int* plane_off, const int* row_len,
                            const int16_t* codes, const __nv_bfloat16* as,
                            const float* x, float* y, int64_t n_groups, int NW,
                            int accumulate, void* stream) {
  return sell::launch_wl(group_ids, slabs, plane_off, row_len, codes,
                         sell::F32Slots<__nv_bfloat16>{{as, x, y}}, n_groups,
                         NW, accumulate, stream);
}

// as2: (hi, lo) value pairs; x2: the interleaved (hi, lo) x table
extern "C" int sell_wl_dd(const int* group_ids, const int* slabs,
                          const int* plane_off, const int* row_len,
                          const int16_t* codes, const float2* as2,
                          const float2* x2, float* y_hi, float* y_lo,
                          int64_t n_groups, int NW, int accumulate,
                          void* stream) {
  return sell::launch_wl(
      group_ids, slabs, plane_off, row_len, codes,
      sell::DDPairs{{nullptr, nullptr, nullptr, nullptr, y_hi, y_lo}, as2,
                    x2},
      n_groups, NW, accumulate, stream);
}
