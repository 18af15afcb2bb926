// Multi-RHS SELL-C-128 SpMM on Hopper: k-major and wl bins, f32 or bf16
// values, x and sums in f32.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/
// pallas_sell_spmm.py `_kernel_k_major_spmm` and `_kernel_wl_spmm`: Y = A·X
// over one bin for R <= 32 right-hand sides. The point of both TPU kernels
// is to load each entry's value and column ONCE for all R.
//
// Layouts and order are those of the SpMV kernels (sell_k_major.cu,
// sell_wl.cu): one 128-row block per (group, row-block), each row's entries
// in the same order, each added with one fmaf per column as F32Sum does, a
// slot whose value is zero adding nothing (sell_common.cuh's stored-zero
// rule: a k-major slot's products are discarded by a select; wl planes hold
// no zero value), and y stored or (with `accumulate`) added onto the same
// way. So column j of the result equals
// the SpMV kernel on X[:, j] bit for bit, where the SpMV kernel runs one
// thread a row (a k-major bin of few groups splits its SpMV rows over
// lanes, which sum in another order).
//
// The x table is row-major: row c holds X[c, 0..R) in its first R floats,
// row stride ldx (a multiple of 4 floats, 16-byte aligned rows), so an
// entry's R x values are contiguous (64 B at R = 16) and read as float4s.
// y is row-major the same way (stride ldy). The kernels compute W = R
// rounded up to 4 columns; the extra ones land in columns the caller
// crops. Pad slots of a k-major bin have value 0 and name a real or the
// spare all-zero slab, so its x table must hold slab_table_rows(ncols)*128
// rows. A wl kernel reads x only at its real slots' columns, all below
// ncols, so it also reads the raw (ncols, R) X in place where its rows are
// whole float4s.
//
// wl reads the compacted planes that the port's upload writes (sell_wl.cu:
// per (group, row-block) a plane as wide as its longest row, each real slot
// a value and a 2-byte code), so one DeviceSell serves SpMV and SpMM. This
// departs from the JAX function, whose `_kernel_wl_spmm` reads unpacked
// lane offsets and returns wrong values on its own default (packed) upload.
// A plane's tail past a row's length holds value 0 and code 0, which may
// name the spare slab, past a raw X's rows: the kernel neither loads nor
// adds such a slot.
//
// What bounds them on an H100: bytes. Every slot streams its value (4 B f32,
// 2 B bf16) and its index (4 B k-major, a 2 B code wl) once for all R;
// y is written once, R f32 per row. The x table (R*4 B per column: 41 MB
// for the headline matrix at R = 16) is re-read through L1/L2 and fits the
// 50 MB L2 at the sizes the harness runs. R*2 FLOP per entry against 6-8 B
// is still below the f32 rate's ridge at R = 32.
//
// What holds a thread-per-row kernel back is how x is read, not HBM bytes:
// at R = 16 its warp's four float4 loads of an entry name 32 different x
// rows each (about 16 cache lines a load), and a 128-row block whose
// columns lie far apart re-reads its x rows from L2. So both kernels split
// R across lanes: G = W/4 rounded up to 1, 2, 4 or 8 lanes own one row,
// each lane one float4 of columns (four f32 sums), so a warp-wide x load
// spans 32/G rows (8 at R = 16), and a block of 128*G threads covers the
// row-block. A warp then reads 32/G rows' plane bytes per load, G times
// fewer than a thread per row did, so the G lanes of a row load different
// slots' columns and values (kSpmmBatch<G> each, all in flight together)
// and pass them on by __shfl_sync as the row's sums take the slots in
// order; each slot's value and column is still read once for all R (wl: the
// loading lane decodes the column before passing it on). Where the
// columns of a k-major block's slots span at most stage_rows x rows (the
// upload's window table x_window, ops/sell.py `_x_window`: first column and
// span per block), the block first copies those rows, nq = W/4 float4s
// each, into shared memory with cp.async and gathers from there
// (banded_adversarial's blocks, whose windows span about 5,100 rows, read x
// from global memory). Rows a warp reads at once are near each other on
// banded matrices, so their float4s mostly fall in different banks. wl
// blocks stage nothing: a block's NW*8 slabs span NW*1024 x rows (64 KB x
// NW at R = 16 on the headline's main bin), and the x table sits in L2. On
// the headline's FEM rows the wl split gains less: the rows a warp holds
// share x rows (three dof rows a node), so a thread per row already read
// few lines a load, and the split's shuffles add work a slot. On the H100
// it ran the headline's bins faster than the thread-per-row kernel before
// it at R <= 4 (one lane a row, its slots' loads batched) and at R = 32,
// and slower at R = 8 and 16 (PERF.md §6).

#include <type_traits>

#include "sell_common.cuh"

namespace sell {

// acc = fmaf(a, x, acc), unless a is zero: then acc as it was (the k-major
// slots' stored-zero rule; the select is on the sum, where the SpMV
// policies of sell_common.cuh select the x operand: with R sums a slot,
// this form kept the k-major SpMM at its time without the rule on the
// H100, PERF.md, PR 11)
__device__ __forceinline__ void fma_or_keep(float& acc, float a, float x) {
  const float t = fmaf(a, x, acc);
  acc = a != 0.f ? t : acc;
}

// slots whose column and value loads a lane keeps in flight: 8 when a row
// has one lane, 4 when it has more (G*4 slots a row; fewer registers, so
// more warps an SM: faster at R = 8, 16 and 32 on the H100)
template <int G>
constexpr int kSpmmBatch = G == 1 ? 8 : 4;

// wl: slots whose x loads a lane issues before it adds them (a divisor of
// G*kSpmmBatch<G>): 8 with one lane a row; 1 with more, where more of them
// took registers, so fewer warps an SM, and ran slower on the H100
// (PERF.md §6)
template <int G>
constexpr int kWlXRound = G == 1 ? 8 : 1;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four f32 sums of a row, one column each: acc = fmaf(a, x, acc), unless a
// is zero.
__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  fma_or_keep(acc.x, a, x.x);
  fma_or_keep(acc.y, a, x.y);
  fma_or_keep(acc.z, a, x.z);
  fma_or_keep(acc.w, a, x.w);
}

// Lane p's four sums of one row over its K entries, from plane offset `off`
// on: x rows gathered from the staged window xs (rows c0..) or from x. The
// G lanes of the row load the columns and values of G*kSpmmBatch<G> slots
// at once, lane p those of slots k0 + u*G + p, and pass each on with
// __shfl_sync as the sums take the slots in order.
template <typename T, int G, bool kStaged>
__device__ __forceinline__ float4 k_major_sums(
    const int* __restrict__ ja, const T* __restrict__ as,
    const float4* xs, int c0, const float* __restrict__ x, int64_t ldx,
    int K, int nq, int p, int64_t off) {
  constexpr int B = kSpmmBatch<G>;
  const int64_t stride = int64_t(kSublanes) * kLanes;  // entry k to k+1
  const int first = (threadIdx.x & 31) - p;            // the row's lane 0
  const bool live = p < nq;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += G * B, off += G * B * stride) {
    int col[B];
    float a[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      col[u] = 0;
      a[u] = 0.f;
      if (k0 + u * G + p < K) {
        col[u] = __ldg(ja + off + (u * G + p) * stride);
        a[u] = widen(__ldg(as + off + (u * G + p) * stride));
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (k0 + u * G + q < K) {  // uniform across the warp
          const int c = G == 1 ? col[u] : __shfl_sync(~0u, col[u], first + q);
          const float v = G == 1 ? a[u] : __shfl_sync(~0u, a[u], first + q);
          float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live) {
            if constexpr (kStaged) {
              xv = xs[(c - c0) * nq + p];
            } else {
              xv = __ldg(reinterpret_cast<const float4*>(x + int64_t(c) * ldx)
                         + p);
            }
          }
          fma4(acc, v, xv);
        }
      }
    }
  }
  return acc;
}

template <typename T, int G>
__global__ void __launch_bounds__(kLanes* G)
k_major_spmm_kernel(const int* __restrict__ group_ids,
                    const int* __restrict__ ja,
                    const int2* __restrict__ x_window,
                    const T* __restrict__ as, const float* __restrict__ x,
                    float* __restrict__ y, int K, int stage_rows, int nq,
                    int64_t ldx, int64_t ldy, int accumulate) {
  extern __shared__ float4 xs[];  // the staged window, nq float4s a row
  const int64_t g = blockIdx.x / kSublanes;
  const int i = blockIdx.x % kSublanes;
  const int j = threadIdx.x / G;  // the block's row
  const int p = threadIdx.x % G;  // its float4 of columns
  const int2 win = __ldg(x_window + blockIdx.x);  // (first column, span)
  const int64_t off = (g * K * kSublanes + i) * kLanes + j;
  float4 acc;
  if (win.y <= stage_rows) {  // uniform across the block
    const float* base = x + int64_t(win.x) * ldx;
    for (int e = threadIdx.x; e < win.y * nq; e += kLanes * G) {
      const int r = e / nq;
      cp_async16(xs + e, base + int64_t(r) * ldx + 4 * (e - r * nq));
    }
    cp_async_wait_all();
    __syncthreads();
    acc = k_major_sums<T, G, true>(ja, as, xs, win.x, x, ldx, K, nq, p, off);
  } else {
    acc = k_major_sums<T, G, false>(ja, as, xs, 0, x, ldx, K, nq, p, off);
  }
  if (p < nq) {
    const int64_t row = int64_t(group_ids[g]) * kGroupRows + i * kLanes + j;
    float4* yr = reinterpret_cast<float4*>(y + row * ldy) + p;
    if (accumulate) {
      const float4 o = *yr;
      acc = make_float4(o.x + acc.x, o.y + acc.y, o.z + acc.z, o.w + acc.w);
    }
    *yr = acc;
  }
}

// wl: lane p's four sums of row j over its n slots, slot q at plane offset
// off + q*128 as a value and a 2-byte code, whose column is
// x_base[code >> 7] + (code & 127). As k_major_sums, the G lanes of the
// row load the codes and values of G*kSpmmBatch<G> slots at once, lane p
// those of slots q0 + u*G + p; the loading lane decodes the column and
// passes it and the value on with __shfl_sync, and each lane loads the x
// rows of kWlXRound<G> slots before the sums take them in order, one fmaf a
// slot (the planes hold no zero value). Rows differ in length within a
// warp: n_warp, the longest of the warp's rows, bounds the loop, so every
// lane takes part in every shuffle; a slot q >= n (value 0, code 0, which
// may name the spare slab, past a raw X's rows) is neither added nor its x
// row read.
template <typename T, int G>
__device__ __forceinline__ float4 wl_sums(
    const int16_t* __restrict__ codes, const T* __restrict__ as,
    const int* x_base, const float* __restrict__ x, int64_t ldx, int n,
    int n_warp, int nq, int p, int64_t off) {
  constexpr int B = kSpmmBatch<G>;
  constexpr int C = kWlXRound<G>;
  static_assert((G * B) % C == 0, "whole rounds of slots");
  const int first = (threadIdx.x & 31) - p;  // the row's lane 0
  const bool live = p < nq;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < n_warp; q0 += G * B, off += G * B * kLanes) {
    int col[B];
    float a[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      col[u] = 0;
      a[u] = 0.f;
      if (q0 + u * G + p < n) {
        const int c = __ldg(codes + off + (u * G + p) * kLanes);
        col[u] = x_base[c >> 7] + (c & (kLanes - 1));
        a[u] = widen(__ldg(as + off + (u * G + p) * kLanes));
      }
    }
#pragma unroll
    for (int s0 = 0; s0 < G * B; s0 += C) {  // slots q0 + s0 + t
      int c[C];
      float v[C];
      float4 xv[C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int u = (s0 + t) / G, q = (s0 + t) % G;
        c[t] = col[u];
        v[t] = a[u];
        if (G > 1 && q0 + s0 + t < n_warp) {  // uniform across the warp
          c[t] = __shfl_sync(~0u, col[u], first + q);
          v[t] = __shfl_sync(~0u, a[u], first + q);
        }
      }
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float4* xr =
            reinterpret_cast<const float4*>(x + int64_t(c[t]) * ldx) + p;
        xv[t] = make_float4(0.f, 0.f, 0.f, 0.f);
        // the same loads written two ways: on the H100 the first ran the
        // bins faster at G = 1 and the second at G = 2 (PERF.md §6)
        if constexpr (G == 1) {
          if (q0 + s0 + t < n) xv[t] = live ? __ldg(xr) : xv[t];
        } else {
          if (live && q0 + s0 + t < n) xv[t] = __ldg(xr);
        }
      }
#pragma unroll
      for (int t = 0; t < C; ++t) {
        if (q0 + s0 + t < n) {
          acc.x = fmaf(v[t], xv[t].x, acc.x);
          acc.y = fmaf(v[t], xv[t].y, acc.y);
          acc.z = fmaf(v[t], xv[t].z, acc.z);
          acc.w = fmaf(v[t], xv[t].w, acc.w);
        }
      }
    }
  }
  return acc;
}

// wl: one block of 128*G threads per (group, row-block) b = g*8 + rb, G
// lanes a row as in k_major_spmm_kernel; the block's NW*8 slab offsets in
// shared memory.
template <typename T, int G>
__global__ void __launch_bounds__(kLanes* G)
wl_spmm_kernel(const int* __restrict__ group_ids, const int* __restrict__ slabs,
               const int* __restrict__ plane_off,
               const int* __restrict__ row_len,
               const int16_t* __restrict__ codes, const T* __restrict__ as,
               const float* __restrict__ x, float* __restrict__ y, int NW,
               int nq, int64_t ldx, int64_t ldy, int accumulate) {
  extern __shared__ int x_base[];  // NW*8 slot columns 128*slab
  const int b = blockIdx.x;        // g*8 + rb
  const int j = threadIdx.x / G;   // the block's row
  const int p = threadIdx.x % G;   // its float4 of columns
  const int nslot = NW * 8;
  const int* block_slabs = slabs + int64_t(b) * nslot;
  for (int q = threadIdx.x; q < nslot; q += kLanes * G) {
    x_base[q] = __ldg(block_slabs + q) * kLanes;
  }
  __syncthreads();

  const int n = __ldg(row_len + int64_t(b) * kLanes + j);
  const int n_warp = G == 1 ? n : __reduce_max_sync(~0u, n);
  float4 acc = wl_sums<T, G>(codes, as, x_base, x, ldx, n, n_warp, nq, p,
                             int64_t(__ldg(plane_off + b)) * kLanes + j);
  if (p < nq) {
    const int64_t row = int64_t(group_ids[b / kSublanes]) * kGroupRows +
                        (b % kSublanes) * kLanes + j;
    float4* yr = reinterpret_cast<float4*>(y + row * ldy) + p;
    if (accumulate) {
      const float4 o = *yr;
      acc = make_float4(o.x + acc.x, o.y + acc.y, o.z + acc.z, o.w + acc.w);
    }
    *yr = acc;
  }
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
int launch_k_major_spmm(const int* group_ids, const int* ja,
                        const int2* x_window, const T* as, const float* x,
                        float* y, int64_t n_groups, int K, int stage_rows,
                        int W, int64_t ldx, int64_t ldy, int accumulate,
                        void* stream) {
  return with_nacc(W, [&](auto nacc) {
    constexpr int G = decltype(nacc)::value / 4;  // lanes a row
    const int nq = W / 4;
    const size_t smem = size_t(stage_rows) * nq * sizeof(float4);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          k_major_spmm_kernel<T, G>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
    }
    if (n_groups > 0) {
      k_major_spmm_kernel<T, G>
          <<<dim3(unsigned(n_groups * kSublanes)), kLanes * G, smem,
             static_cast<cudaStream_t>(stream)>>>(
              group_ids, ja, x_window, as, x, y, K, stage_rows, nq, ldx, ldy,
              accumulate);
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
    constexpr int G = decltype(nacc)::value / 4;  // lanes a row
    if (n_groups > 0) {
      wl_spmm_kernel<T, G>
          <<<dim3(unsigned(n_groups * kSublanes)), kLanes * G,
             size_t(NW) * 8 * sizeof(int),
             static_cast<cudaStream_t>(stream)>>>(
              group_ids, slabs, plane_off, row_len, codes, as, x, y, NW,
              W / 4, ldx, ldy, accumulate);
    }
    return int(cudaGetLastError());
  });
}

}  // namespace sell

// x_window: (n_groups*8) (first column, span) pairs; stage_rows: the widest
// span a block stages (its shared memory), 0 for none
extern "C" int sell_k_major_spmm_f32(const int* group_ids, const int* ja,
                                     const int2* x_window, const float* as,
                                     const float* x, float* y,
                                     int64_t n_groups, int K, int stage_rows,
                                     int W, int64_t ldx, int64_t ldy,
                                     int accumulate, void* stream) {
  return sell::launch_k_major_spmm(group_ids, ja, x_window, as, x, y,
                                   n_groups, K, stage_rows, W, ldx, ldy,
                                   accumulate, stream);
}

extern "C" int sell_k_major_spmm_bf16(const int* group_ids, const int* ja,
                                      const int2* x_window,
                                      const __nv_bfloat16* as, const float* x,
                                      float* y, int64_t n_groups, int K,
                                      int stage_rows, int W, int64_t ldx,
                                      int64_t ldy, int accumulate,
                                      void* stream) {
  return sell::launch_k_major_spmm(group_ids, ja, x_window, as, x, y,
                                   n_groups, K, stage_rows, W, ldx, ldy,
                                   accumulate, stream);
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
