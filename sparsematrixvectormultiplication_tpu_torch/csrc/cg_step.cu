// Conjugate gradients' vector work: one iteration's update, its dot products
// and the stop test's comparison, with the scalars kept on the card.
//
// Replaces the body of the TPU package's CG loop (solvers/cg.py, the
// `lax.while_loop` body around the matvec), which XLA fuses into a few
// device ops. The port ran it as eager PyTorch ops: three `torch.vdot` (a
// cuBLAS dot and a reduce each), two scalar divides, seven elementwise ops
// and the stop test's compare, some 17 launches an iteration, with the host
// paying more for each than the card. Here a solve's state is the vectors x,
// r, p (z = minv * r is never stored), one workspace (`Work`) that holds
// alpha, beta, rz, rr and atol2, and a pinned host word for the stop flag;
// the kernels below take their place:
//
//   cg_init  after ax = A x0:  r = b - ax, p = minv * r; bb = b.b,
//            rz = r.(minv r), rr = r.r; atol2 = (tol * sqrt(bb))^2 and the
//            flag rr > atol2.
//   cg_alpha after ap = A p:   alpha = rz / p.ap.
//   cg_step                    x += alpha p, r -= alpha ap; rz' = r.(minv r),
//            rr = r.r; beta = rz' / rz, rz = rz', the flag rr > atol2.
//   cg_dir                     p = minv * r + beta p.
//
// The flag is written to a mapped, pinned host word, which the host polls
// (cg_flag): one read an iteration, as the eager loop's `bool(rr > atol2)`,
// that waits for the launch that writes it and not for the work queued
// behind it (the next matvec). A null minv is the unpreconditioned solve
// (z = r).
//
// Sums across blocks use the last-block pattern: each block writes its
// partial sums (a fixed tree of its threads' sums), an atomic ticket picks
// the last block to finish, and that block adds the partials in a fixed
// order, derives the scalars and resets the ticket. The grid is a function
// of n alone (at most kMaxBlocks blocks, grid-stride loops), so a repeated
// solve is bit for bit the same. Sums are in the state's type, as the
// eager dots: float or double.
//
// What bounds them on an H100: bytes. fem3d_cube's 648,000 rows in f32 are
// 2.6 MB a vector: cg_step reads five and writes two (18 MB, 5.4 us at
// 3.35 TB/s), cg_dir reads three and writes one, cg_alpha reads two. One
// thread an entry, 256-thread blocks, every load and store coalesced. An
// iteration's three kernels took 18.9 us there against a 10.1 us bound:
// each reduction's second pass and the launches' gaps, beside a 153 us
// matvec. A grid-wide sync merging them (a cooperative launch) could save
// only part of that, so they stay three launches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;

// The workspace: the scalars first (read by the host as a T view: index 3 is
// rr), then the ticket, then the partial sums of one reduction.
template <typename T>
struct Work {
  T alpha, beta, rz, rr, atol2;
  unsigned ticket;
  T partial[3][kMaxBlocks];
};

// Sums v[0..NS) over the block by a fixed tree; the result in thread 0.
template <typename T, int NS>
__device__ __forceinline__ void block_sum(T (&v)[NS]) {
  __shared__ T sh[NS][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[s] += __shfl_down_sync(0xffffffffu, v[s], off);
    if (lane == 0) sh[s][warp] = v[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      v[s] = lane < kWarps ? sh[s][lane] : T(0);
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1)
        v[s] += __shfl_down_sync(0xffffffffu, v[s], off);
    }
  }
}

// Posts the block's sums (in thread 0) and returns true in thread 0 of the
// last block to finish, with the grid's sums in tot; false elsewhere.
template <typename T, int NS>
__device__ __forceinline__ bool grid_sum(Work<T>* w, T (&v)[NS],
                                         T (&tot)[NS]) {
  __shared__ bool last;
  block_sum<T, NS>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) w->partial[s][blockIdx.x] = v[s];
    __threadfence();
    last = atomicAdd(&w->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    tot[s] = T(0);
    for (int i = threadIdx.x; i < int(gridDim.x); i += kThreads)
      tot[s] += __ldcg(&w->partial[s][i]);
  }
  block_sum<T, NS>(tot);
  if (threadIdx.x != 0) return false;
  w->ticket = 0u;
  return true;
}

template <typename T>
__device__ __forceinline__ void set_flag(const Work<T>* w, int* hflag) {
  *reinterpret_cast<volatile int*>(hflag) = w->rr > w->atol2;
  __threadfence_system();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_init_kernel(const T* __restrict__ b, const T* __restrict__ ax,
               const T* __restrict__ minv, T* __restrict__ r,
               T* __restrict__ p, Work<T>* w, int* hflag, int64_t n,
               double tol) {
  T v[3] = {T(0), T(0), T(0)}, tot[3];  // bb, rz, rr
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const T bi = b[i];
    const T ri = bi - ax[i];
    const T zi = minv != nullptr ? minv[i] * ri : ri;
    r[i] = ri;
    p[i] = zi;
    v[0] += bi * bi;
    v[1] += ri * zi;
    v[2] += ri * ri;
  }
  if (!grid_sum<T, 3>(w, v, tot)) return;
  const T atol = T(tol) * sqrt(tot[0]);
  w->atol2 = atol * atol;
  w->rz = tot[1];
  w->rr = tot[2];
  set_flag(w, hflag);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_alpha_kernel(const T* __restrict__ p, const T* __restrict__ ap,
                Work<T>* w, int64_t n) {
  T v[1] = {T(0)}, tot[1];
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride)
    v[0] += p[i] * ap[i];
  if (!grid_sum<T, 1>(w, v, tot)) return;
  w->alpha = w->rz / tot[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_step_kernel(T* __restrict__ x, T* __restrict__ r,
               const T* __restrict__ ap, const T* __restrict__ p,
               const T* __restrict__ minv, Work<T>* w, int* hflag,
               int64_t n) {
  const T alpha = w->alpha;
  T v[2] = {T(0), T(0)}, tot[2];  // rz', rr
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    x[i] += alpha * p[i];
    const T ri = r[i] - alpha * ap[i];
    const T zi = minv != nullptr ? minv[i] * ri : ri;
    r[i] = ri;
    v[0] += ri * zi;
    v[1] += ri * ri;
  }
  if (!grid_sum<T, 2>(w, v, tot)) return;
  w->beta = tot[0] / w->rz;
  w->rz = tot[0];
  w->rr = tot[1];
  set_flag(w, hflag);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_dir_kernel(const T* __restrict__ r, const T* __restrict__ minv,
              T* __restrict__ p, const Work<T>* w, int64_t n) {
  const T beta = w->beta;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const T ri = r[i];
    p[i] = (minv != nullptr ? minv[i] * ri : ri) + beta * p[i];
  }
}

unsigned blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return unsigned(b < 1 ? 1 : b > kMaxBlocks ? kMaxBlocks : b);
}

template <typename T>
int init(const T* b, const T* ax, const T* minv, T* r, T* p, void* w,
         int* hflag, int64_t n, double tol, void* stream) {
  cg_init_kernel<T><<<blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      b, ax, minv, r, p, static_cast<Work<T>*>(w), hflag, n, tol);
  return int(cudaGetLastError());
}

template <typename T>
int alpha(const T* p, const T* ap, void* w, int64_t n, void* stream) {
  cg_alpha_kernel<T><<<blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, ap, static_cast<Work<T>*>(w), n);
  return int(cudaGetLastError());
}

template <typename T>
int step(T* x, T* r, const T* ap, const T* p, const T* minv, void* w,
         int* hflag, int64_t n, void* stream) {
  cg_step_kernel<T><<<blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, r, ap, p, minv, static_cast<Work<T>*>(w), hflag, n);
  return int(cudaGetLastError());
}

template <typename T>
int dir(const T* r, const T* minv, T* p, const void* w, int64_t n,
        void* stream) {
  cg_dir_kernel<T><<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      r, minv, p, static_cast<const Work<T>*>(w), n);
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of the workspace for a state of `elem` bytes an entry (4, 8); it
// must start zeroed (the ticket).
extern "C" int64_t cg_work_bytes(int elem) {
  return elem == 8 ? int64_t(sizeof(Work<double>))
                   : int64_t(sizeof(Work<float>));
}

// The device address of a pinned host word, for the kernels' flag; 0 when
// it has none.
extern "C" int64_t cg_flag_pointer(int* host) {
  void* dev = nullptr;
  if (cudaHostGetDevicePointer(&dev, host, 0) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return reinterpret_cast<int64_t>(dev);
}

// Waits until the host word, set to -1 before a cg_init or cg_step launch,
// holds that launch's flag (0 or 1) and returns it, without waiting for the
// work queued behind it; minus the CUDA error where the stream fails, or
// kNoFlag where it drains and the word was not written.
constexpr int kNoFlag = -1000;

extern "C" int cg_flag(const int* host, void* stream) {
  const volatile int* word = host;
  for (;;) {
    if (*word >= 0) return *word;
    const cudaError_t q = cudaStreamQuery(static_cast<cudaStream_t>(stream));
    if (q == cudaSuccess) return *word >= 0 ? *word : kNoFlag;
    if (q != cudaErrorNotReady) return -int(q);
  }
}

// b, ax, minv (or null), r, p: n entries each; w: cg_work_bytes, zeroed
// before a solve's first launch; hflag: cg_flag_pointer's address
#define CG_ENTRIES(T, V)                                                     \
  extern "C" int cg_init_##V(const T* b, const T* ax, const T* minv, T* r,  \
                             T* p, void* w, int* hflag, int64_t n,           \
                             double tol, void* stream) {                     \
    return init<T>(b, ax, minv, r, p, w, hflag, n, tol, stream);             \
  }                                                                          \
  extern "C" int cg_alpha_##V(const T* p, const T* ap, void* w, int64_t n,  \
                              void* stream) {                                \
    return alpha<T>(p, ap, w, n, stream);                                    \
  }                                                                          \
  extern "C" int cg_step_##V(T* x, T* r, const T* ap, const T* p,           \
                             const T* minv, void* w, int* hflag, int64_t n,  \
                             void* stream) {                                 \
    return step<T>(x, r, ap, p, minv, w, hflag, n, stream);                  \
  }                                                                          \
  extern "C" int cg_dir_##V(const T* r, const T* minv, T* p, const void* w, \
                            int64_t n, void* stream) {                       \
    return dir<T>(r, minv, p, w, n, stream);                                 \
  }

CG_ENTRIES(float, f32)
CG_ENTRIES(double, f64)
