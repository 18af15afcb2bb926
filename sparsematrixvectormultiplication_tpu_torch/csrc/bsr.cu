// 128x128 block-sparse (BSR) SpMM on Hopper: Y = A·X with f32 or bf16
// blocks and X, f32 sums and Y.
//
// Replaces the TPU kernels sparsematrixvectormultiplication_tpu/ops/
// pallas_bsr.py `_kernel` (the X slab reaches VMEM through a BlockSpec index
// map) and `_kernel_dma` (the kernel copies it in with make_async_copy):
//   Y[128g : 128g+128, :] = sum_j blocks[g*kb + j] @ X[128*bc : 128*bc+128, :],
//   bc = block_cols[g*kb + j].
// The TPU walks j on a sequential grid axis with the Y tile resident in VMEM
// and zeroed at j = 0. Here one thread block owns a 128 x kTileB tile of Y in
// registers, loops over the kb slots itself and writes the tile once: no
// zero-fill, no atomics. Columns of Y at or past B are not written (the
// ragged edge); rows past nrows are written into the padded Y and cropped by
// the caller.
//
// Both routes stream (128 x kDepth) sub-tiles of a block and (kDepth x
// kTileB) sub-tiles of its X slab through shared memory:
//   blockspec: ordinary 16-byte loads, widened to f32 and stored, one stage
//              at a time;
//   dma:       cp.async copies of the raw bytes into two buffers, the next
//              stage's copy in flight while this stage is multiplied; bf16 is
//              widened as it is read from shared memory.
// Each of the 256 threads accumulates an 8 x 8 micro-tile (rows ty + 16r,
// columns 8tx .. 8tx+7) with FFMA, in the order slot j, then k.
//
// Precision: IEEE f32 fmaf only, no tensor cores, so no TF32 rounding. bf16
// blocks and X are widened to f32; a bf16 x bf16 product is exact in f32, so
// this is bf16 in with f32 accumulation, the TPU's single bf16 pass.
//
// What bounds it on an H100: operations. The kernel multiplies every stored
// block densely, pad slots and zeros included: 2*128^3 FLOP per slot per 128
// columns of X (band64_250k: 5,862 slots, 24.6 GFLOP at B = 128, where the
// function needs 3.2) at 67 TFLOP/s f32, 0.37 ms, against 0.11 ms for the
// function's bytes (entries, X, Y) at 3.35 TB/s. Skipping zero sub-tiles, or
// bf16 on the tensor cores (wgmma), are the levers a later change can pull.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bsr {

constexpr int kBlock = 128;    // block edge
constexpr int kTileB = 128;    // Y columns per thread block
constexpr int kDepth = 16;     // k per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, an 8 x 8 micro-tile each
constexpr int kStagesPerSlot = kBlock / kDepth;

// A sub-tile rows padded by 16 B: rows stay 16 B aligned and the two ty of
// a warp read different banks
template <typename S>
__host__ __device__ constexpr int lda() {
  return kDepth + 16 / int(sizeof(S));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of T as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// 8 consecutive values at p (16 B aligned) as floats
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  unpack16(*reinterpret_cast<const uint4*>(p), v, p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where stage s of block-row g reads: the block's element (0, d0) and the
// X element (row0, c0) of its slab
template <typename T>
struct Stage {
  const T* a;
  const T* x;
};

template <typename T>
__device__ __forceinline__ Stage<T> stage_at(const int* block_cols,
                                             const T* blocks, const T* x,
                                             int g, int kb, int s, int c0,
                                             int64_t ldx) {
  const int64_t slot = int64_t(g) * kb + s / kStagesPerSlot;
  const int d0 = (s % kStagesPerSlot) * kDepth;
  const int64_t row0 = int64_t(__ldg(block_cols + slot)) * kBlock + d0;
  return {blocks + slot * kBlock * kBlock + d0, x + row0 * ldx + c0};
}

// blockspec: load a stage with 16-byte loads and store it widened to f32.
// X chunks at or past column B (chunk starts are multiples of 16 B, and
// ldx >= B rounded up to 8) are stored as zeros.
template <typename T>
__device__ __forceinline__ void load_stage(float* sa, float* sx, Stage<T> st,
                                           int c0, int B, int64_t ldx,
                                           int tid) {
  constexpr int V = 16 / sizeof(T);
  float f[V];
  for (int q = tid; q < kBlock * kDepth / V; q += kThreads) {
    const int m = q / (kDepth / V), d = (q % (kDepth / V)) * V;
    unpack16(__ldg(reinterpret_cast<const uint4*>(st.a + m * kBlock + d)), f,
             st.a);
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      *reinterpret_cast<float4*>(sa + m * lda<float>() + d + v) =
          make_float4(f[v], f[v + 1], f[v + 2], f[v + 3]);
    }
  }
  for (int q = tid; q < kDepth * kTileB / V; q += kThreads) {
    const int k = q / (kTileB / V), c = (q % (kTileB / V)) * V;
    if (c0 + c < B) {
      unpack16(__ldg(reinterpret_cast<const uint4*>(st.x + k * ldx + c)), f,
               st.x);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      *reinterpret_cast<float4*>(sx + k * kTileB + c + v) =
          make_float4(f[v], f[v + 1], f[v + 2], f[v + 3]);
    }
  }
}

// dma: issue cp.async copies of a stage's raw bytes; X chunks at or past
// column B are zero-filled without a read
template <typename T>
__device__ __forceinline__ void copy_stage(T* sa, T* sx, Stage<T> st, int c0,
                                           int B, int64_t ldx, int tid) {
  constexpr int V = 16 / sizeof(T);
  for (int q = tid; q < kBlock * kDepth / V; q += kThreads) {
    const int m = q / (kDepth / V), d = (q % (kDepth / V)) * V;
    cp_async16(sa + m * lda<T>() + d, st.a + m * kBlock + d, 16);
  }
  for (int q = tid; q < kDepth * kTileB / V; q += kThreads) {
    const int k = q / (kTileB / V), c = (q % (kTileB / V)) * V;
    const bool in = c0 + c < B;
    cp_async16(sx + k * kTileB + c, in ? st.x + k * ldx + c : st.x,
               in ? 16 : 0);
  }
}

// acc[r][c] += A[ty + 16r, d] * X[d, 8tx + c] over the stage's kDepth
template <typename S>
__device__ __forceinline__ void multiply_stage(const S* sa, const S* sx,
                                               float (&acc)[8][8], int tx,
                                               int ty) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    float av[8], xv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = widen(sa[(ty + 16 * r) * lda<S>() + d]);
    load8(sx + d * kTileB + 8 * tx, xv);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], xv[c], acc[r][c]);
    }
  }
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ block_cols, const T* __restrict__ blocks,
           const T* __restrict__ x, float* __restrict__ y, int kb, int B,
           int64_t ldx, int64_t ldy) {
  using S = std::conditional_t<kAsync, T, float>;  // shared-memory type
  constexpr int kBufs = kAsync ? 2 : 1;
  __shared__ __align__(16) S sa[kBufs][kBlock * lda<S>()];
  __shared__ __align__(16) S sx[kBufs][kDepth * kTileB];
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * kTileB;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
  const int n = kb * kStagesPerSlot;
  if constexpr (kAsync) {
    copy_stage(sa[0], sx[0], stage_at(block_cols, blocks, x, g, kb, 0, c0, ldx),
               c0, B, ldx, tid);
    cp_async_commit();
    for (int s = 0; s < n; ++s) {
      if (s + 1 < n) {
        const int b = (s + 1) & 1;
        copy_stage(sa[b], sx[b],
                   stage_at(block_cols, blocks, x, g, kb, s + 1, c0, ldx), c0,
                   B, ldx, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      multiply_stage(sa[s & 1], sx[s & 1], acc, tx, ty);
      __syncthreads();  // buffer s & 1 is refilled at stage s + 2
    }
  } else {
    for (int s = 0; s < n; ++s) {
      load_stage(sa[0], sx[0], stage_at(block_cols, blocks, x, g, kb, s, c0, ldx),
                 c0, B, ldx, tid);
      __syncthreads();
      multiply_stage(sa[0], sx[0], acc, tx, ty);
      __syncthreads();
    }
  }
  const int col = c0 + 8 * tx;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* yr = y + (int64_t(g) * kBlock + ty + 16 * r) * ldy + col;
    if (col + 8 <= B) {
      *reinterpret_cast<float4*>(yr) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(yr + 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (col + c < B) yr[c] = acc[r][c];
      }
    }
  }
}

template <typename T, bool kAsync>
int launch(const int* block_cols, const T* blocks, const T* x, float* y,
           int64_t n_block_rows, int kb, int B, int64_t ldx, int64_t ldy,
           void* stream) {
  if (n_block_rows > 0 && B > 0) {
    const dim3 grid(unsigned(n_block_rows), unsigned((B + kTileB - 1) / kTileB));
    bsr_kernel<T, kAsync><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        block_cols, blocks, x, y, kb, B, ldx, ldy);
  }
  return int(cudaGetLastError());
}

}  // namespace bsr

// block_cols (n_block_rows*kb,) int32; blocks (n_block_rows*kb, 128, 128);
// x (n_block_cols*128, B) with row stride ldx (a multiple of 8, >= B);
// y (n_block_rows*128, B) f32 with row stride ldy (a multiple of 4, >= B)
#define BSR_ENTRY(route, async, tag, T)                                       \
  extern "C" int bsr_spmm_##route##_##tag(                                    \
      const int* block_cols, const T* blocks, const T* x, float* y,           \
      int64_t n_block_rows, int kb, int B, int64_t ldx, int64_t ldy,          \
      void* stream) {                                                         \
    return bsr::launch<T, async>(block_cols, blocks, x, y, n_block_rows, kb,  \
                                 B, ldx, ldy, stream);                        \
  }

BSR_ENTRY(blockspec, false, f32, float)
BSR_ENTRY(blockspec, false, bf16, __nv_bfloat16)
BSR_ENTRY(dma, true, f32, float)
BSR_ENTRY(dma, true, bf16, __nv_bfloat16)
