// Multi-RHS SELL-C-128 SpMM on Hopper: k-major and wl bins, f32 or bf16
// values, x and sums in f32.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/
// pallas_sell_spmm.py `_kernel_k_major_spmm` and `_kernel_wl_spmm`: Y = A·X
// over one bin for R <= 32 right-hand sides. The point of both TPU kernels
// is to load each entry's value and column ONCE for all R; here each thread
// keeps R f32 sums in registers and reads its entries once.
//
// Layouts and order are those of the SpMV kernels (sell_k_major.cu,
// sell_wl.cu): one thread per output row, one 128-thread block per (group,
// row-block), entries in the same order, each added with one fmaf as
// F32Sum does, and y stored or (with `accumulate`) added onto the same way.
// So column j of the result equals the SpMV kernel on X[:, j] bit for bit.
//
// The x table is row-major: row c holds X[c, 0..R) in its first R floats,
// row stride ldx (a multiple of 4 floats, 16-byte aligned rows), so an
// entry's R x values are contiguous (64 B at R = 16) and read as float4s.
// y is row-major the same way (stride ldy). The kernel computes W = R
// rounded up to 4 columns; the extra ones land in columns the caller
// crops. Pad slots of a bin have value 0 and name a real or the spare
// all-zero slab, so the x table must hold slab_table_rows(ncols)*128 rows.
//
// wl reads the compacted planes that the port's upload writes (sell_wl.cu:
// per (group, row-block) a plane as wide as its longest row, each real slot
// a value and a 2-byte code), so one DeviceSell serves SpMV and SpMM. This
// departs from the JAX function, whose `_kernel_wl_spmm` reads unpacked
// lane offsets and returns wrong values on its own default (packed) upload.
//
// What bounds it on an H100: bytes. Every slot streams its value (4 B f32,
// 2 B bf16) and its index (4 B k-major, a 2 B code wl) once for all R;
// y is written once, R f32 per row. The x table (R*4 B per column: 41 MB
// for the headline matrix at R = 16) is re-read through L1/L2 and fits the
// 50 MB L2 at the sizes the harness runs. R*2 FLOP per entry against 6-8 B
// is still below the f32 rate's ridge at R = 32.

#include <type_traits>

#include "sell_common.cuh"

namespace sell {

// R' = NACC f32 sums of one row; q-th float4 group live when q < nq
template <int NACC>
struct RowSums {
  float v[NACC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < NACC; ++r) v[r] = 0.f;
  }
  // v[r] = fmaf(a, xr[r], v[r]) for r < 4*nq
  __device__ __forceinline__ void add(float a, const float* __restrict__ xr,
                                      int nq) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll
    for (int q = 0; q < NACC / 4; ++q) {
      if (q < nq) {
        const float4 t = __ldg(x4 + q);
        v[4 * q + 0] = fmaf(a, t.x, v[4 * q + 0]);
        v[4 * q + 1] = fmaf(a, t.y, v[4 * q + 1]);
        v[4 * q + 2] = fmaf(a, t.z, v[4 * q + 2]);
        v[4 * q + 3] = fmaf(a, t.w, v[4 * q + 3]);
      }
    }
  }
  __device__ __forceinline__ void store(float* yr, int nq,
                                        int accumulate) const {
    float4* y4 = reinterpret_cast<float4*>(yr);
#pragma unroll
    for (int q = 0; q < NACC / 4; ++q) {
      if (q < nq) {
        float4 t = make_float4(v[4 * q + 0], v[4 * q + 1], v[4 * q + 2],
                               v[4 * q + 3]);
        if (accumulate) {
          const float4 o = y4[q];
          t = make_float4(o.x + t.x, o.y + t.y, o.z + t.z, o.w + t.w);
        }
        y4[q] = t;
      }
    }
  }
};

template <typename T, int NACC>
__global__ void __launch_bounds__(kLanes)
k_major_spmm_kernel(const int* __restrict__ group_ids,
                    const int* __restrict__ ja, const T* __restrict__ as,
                    const float* __restrict__ x, float* __restrict__ y, int K,
                    int nq, int64_t ldx, int64_t ldy, int accumulate) {
  const int64_t g = blockIdx.x / kSublanes;
  const int i = blockIdx.x % kSublanes;
  const int j = threadIdx.x;
  const int64_t stride = int64_t(kSublanes) * kLanes;  // from entry k to k+1
  int64_t off = (g * K * kSublanes + i) * kLanes + j;
  RowSums<NACC> acc;
  acc.zero();
  for (int k = 0; k < K; ++k, off += stride) {
    acc.add(widen(__ldg(as + off)), x + int64_t(__ldg(ja + off)) * ldx, nq);
  }
  const int64_t row = int64_t(group_ids[g]) * kGroupRows + i * kLanes + j;
  acc.store(y + row * ldy, nq, accumulate);
}

template <typename T, int NACC>
__global__ void __launch_bounds__(kLanes)
wl_spmm_kernel(const int* __restrict__ group_ids, const int* __restrict__ slabs,
               const int* __restrict__ plane_off,
               const int* __restrict__ row_len,
               const int16_t* __restrict__ codes, const T* __restrict__ as,
               const float* __restrict__ x, float* __restrict__ y, int NW,
               int nq, int64_t ldx, int64_t ldy, int accumulate) {
  extern __shared__ int x_base[];  // NW*8 slot columns 128*slab
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
  RowSums<NACC> acc;
  acc.zero();
  for (int q = 0; q < n; ++q, off += kLanes) {
    const int c = __ldg(codes + off);
    acc.add(widen(__ldg(as + off)),
            x + int64_t(x_base[c >> 7] + (c & (kLanes - 1))) * ldx, nq);
  }
  const int64_t row = int64_t(group_ids[b / kSublanes]) * kGroupRows +
                      (b % kSublanes) * kLanes + j;
  acc.store(y + row * ldy, nq, accumulate);
}

// The accumulator count: the smallest of 4, 8, 16, 32 that holds W columns
// (W a multiple of 4), passed to `launch` as a std::integral_constant.
template <typename Launch>
int with_nacc(int W, Launch launch) {
  if (W <= 0 || W % 4) return int(cudaErrorInvalidValue);
  if (W <= 4) return launch(std::integral_constant<int, 4>{});
  if (W <= 8) return launch(std::integral_constant<int, 8>{});
  if (W <= 16) return launch(std::integral_constant<int, 16>{});
  if (W <= 32) return launch(std::integral_constant<int, 32>{});
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch_k_major_spmm(const int* group_ids, const int* ja, const T* as,
                        const float* x, float* y, int64_t n_groups, int K,
                        int W, int64_t ldx, int64_t ldy, int accumulate,
                        void* stream) {
  return with_nacc(W, [&](auto nacc) {
    if (n_groups > 0) {
      k_major_spmm_kernel<T, decltype(nacc)::value>
          <<<dim3(unsigned(n_groups * kSublanes)), kLanes, 0,
             static_cast<cudaStream_t>(stream)>>>(
              group_ids, ja, as, x, y, K, W / 4, ldx, ldy, accumulate);
    }
    return int(cudaGetLastError());
  });
}

template <typename T>
int launch_wl_spmm(const int* group_ids, const int* slabs, const int* plane_off,
                   const int* row_len, const int16_t* codes, const T* as,
                   const float* x, float* y, int64_t n_groups, int NW, int W,
                   int64_t ldx, int64_t ldy, int accumulate, void* stream) {
  return with_nacc(W, [&](auto nacc) {
    if (n_groups > 0) {
      wl_spmm_kernel<T, decltype(nacc)::value>
          <<<dim3(unsigned(n_groups * kSublanes)), kLanes,
             size_t(NW) * 8 * sizeof(int),
             static_cast<cudaStream_t>(stream)>>>(
              group_ids, slabs, plane_off, row_len, codes, as, x, y, NW,
              W / 4, ldx, ldy, accumulate);
    }
    return int(cudaGetLastError());
  });
}

}  // namespace sell

extern "C" int sell_k_major_spmm_f32(const int* group_ids, const int* ja,
                                     const float* as, const float* x, float* y,
                                     int64_t n_groups, int K, int W,
                                     int64_t ldx, int64_t ldy, int accumulate,
                                     void* stream) {
  return sell::launch_k_major_spmm(group_ids, ja, as, x, y, n_groups, K, W,
                                   ldx, ldy, accumulate, stream);
}

extern "C" int sell_k_major_spmm_bf16(const int* group_ids, const int* ja,
                                      const __nv_bfloat16* as, const float* x,
                                      float* y, int64_t n_groups, int K, int W,
                                      int64_t ldx, int64_t ldy, int accumulate,
                                      void* stream) {
  return sell::launch_k_major_spmm(group_ids, ja, as, x, y, n_groups, K, W,
                                   ldx, ldy, accumulate, stream);
}

extern "C" int sell_wl_spmm_f32(const int* group_ids, const int* slabs,
                                const int* plane_off, const int* row_len,
                                const int16_t* codes, const float* as,
                                const float* x, float* y, int64_t n_groups,
                                int NW, int W, int64_t ldx, int64_t ldy,
                                int accumulate, void* stream) {
  return sell::launch_wl_spmm(group_ids, slabs, plane_off, row_len, codes, as,
                              x, y, n_groups, NW, W, ldx, ldy, accumulate,
                              stream);
}

extern "C" int sell_wl_spmm_bf16(const int* group_ids, const int* slabs,
                                 const int* plane_off, const int* row_len,
                                 const int16_t* codes,
                                 const __nv_bfloat16* as, const float* x,
                                 float* y, int64_t n_groups, int NW, int W,
                                 int64_t ldx, int64_t ldy, int accumulate,
                                 void* stream) {
  return sell::launch_wl_spmm(group_ids, slabs, plane_off, row_len, codes, as,
                              x, y, n_groups, NW, W, ldx, ldy, accumulate,
                              stream);
}
