// fast_bsr.cpp — native CSR→BSR(128x128) blocking for the dense-block SpMM
// path (formats/bsr.py). Replaces the numpy np.unique route (O(nnz log nnz)
// over 8-byte keys) with an O(nnz) stamp-array dedup per 128-row block-row
// — block-rows own CONTIGUOUS entry ranges (rows 128g..128g+127 are
// consecutive in CSR), so the work parallelizes over block-rows with
// per-thread stamp arrays. The same source as the JAX package's
// native/fast_bsr.cpp.
//
// Semantics match the numpy path exactly: block-columns of a block-row
// are stored SORTED, duplicate (row,col) entries SUM (the .mtx oracle
// semantics), pad slots stay zero-filled with block-col 0.
//
// Exposed via ctypes: see native/build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
constexpr int64_t kBlock = 128;

template <typename T>
void fill_range(const int64_t* row_ptr, const int32_t* col,
                const double* val, int64_t nrows, int64_t n_bc, int64_t kb,
                T* blocks, int32_t* bcols, int64_t g0, int64_t g1,
                std::vector<int32_t>& stamp) {
  std::vector<int32_t> list;
  list.reserve((size_t)kb);
  for (int64_t g = g0; g < g1; ++g) {
    int64_t r_lo = g * kBlock;
    int64_t r_hi = std::min(r_lo + kBlock, nrows);
    int64_t e_lo = row_ptr[r_lo], e_hi = row_ptr[r_hi];
    list.clear();
    for (int64_t e = e_lo; e < e_hi; ++e) {
      int32_t bc = col[e] >> 7;
      if (stamp[bc] != (int32_t)g) {
        stamp[bc] = (int32_t)g;
        list.push_back(bc);
      }
    }
    std::sort(list.begin(), list.end());
    for (size_t s = 0; s < list.size(); ++s) bcols[g * kb + (int64_t)s] = list[s];
    // scatter entries: row-major walk keeps the (row, col)-sorted CSR
    // order cache-friendly inside each 64 KiB block
    for (int64_t r = r_lo; r < r_hi; ++r) {
      int64_t lr = r - r_lo;
      for (int64_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
        int32_t c = col[e];
        int32_t bc = c >> 7;
        int64_t slot = std::lower_bound(list.begin(), list.end(), bc) -
                       list.begin();
        int64_t idx = (((g * kb + slot) * kBlock) + lr) * kBlock + (c & 127);
        blocks[idx] += (T)val[e];  // += : duplicate coordinates SUM
      }
    }
  }
}
}  // namespace

extern "C" {

// pass 1: distinct 128x128 blocks per block-row. Returns kb (max count,
// >=1) or <0 on error. counts has n_br = ceil(nrows/128) slots.
int64_t fast_bsr_count(const int64_t* row_ptr, const int32_t* col,
                       int64_t nrows, int64_t n_bc, int num_threads,
                       int64_t* counts) {
  if (nrows <= 0 || n_bc <= 0) return -1;
  int64_t n_br = (nrows + kBlock - 1) / kBlock;
  int nt = std::max(1, std::min<int>(num_threads, (int)std::min<int64_t>(n_br, 64)));
  std::vector<std::thread> ths;
  int64_t per = (n_br + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([&, t]() {
      std::vector<int32_t> stamp((size_t)n_bc, -1);
      int64_t g0 = (int64_t)t * per, g1 = std::min(g0 + per, n_br);
      for (int64_t g = g0; g < g1; ++g) {
        int64_t r_lo = g * kBlock;
        int64_t r_hi = std::min(r_lo + kBlock, nrows);
        int64_t n = 0;
        for (int64_t e = row_ptr[r_lo]; e < row_ptr[r_hi]; ++e) {
          int32_t bc = col[e] >> 7;
          if (bc < 0 || bc >= n_bc) { counts[g] = -2; return; }
          if (stamp[bc] != (int32_t)g) { stamp[bc] = (int32_t)g; ++n; }
        }
        counts[g] = n;
      }
    });
  }
  for (auto& th : ths) th.join();
  int64_t kb = 1;
  for (int64_t g = 0; g < n_br; ++g) {
    if (counts[g] < 0) return -2;  // column out of range
    kb = std::max(kb, counts[g]);
  }
  return kb;
}

// pass 2: fill blocks (n_br*kb, 128, 128) and bcols (n_br*kb). blocks and
// bcols must arrive ZEROED (pad slots stay zero / block-col 0). f32 or
// f64 storage by use_f64. Returns 0 on success.
int64_t fast_bsr_fill(const int64_t* row_ptr, const int32_t* col,
                      const double* val, int64_t nrows, int64_t n_bc,
                      int64_t kb, int num_threads, int use_f64,
                      void* blocks, int32_t* bcols) {
  if (nrows <= 0 || n_bc <= 0 || kb <= 0) return -1;
  int64_t n_br = (nrows + kBlock - 1) / kBlock;
  int nt = std::max(1, std::min<int>(num_threads, (int)std::min<int64_t>(n_br, 64)));
  std::vector<std::thread> ths;
  int64_t per = (n_br + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([&, t]() {
      std::vector<int32_t> stamp((size_t)n_bc, -1);
      int64_t g0 = (int64_t)t * per, g1 = std::min(g0 + per, n_br);
      if (use_f64)
        fill_range<double>(row_ptr, col, val, nrows, n_bc, kb,
                           (double*)blocks, bcols, g0, g1, stamp);
      else
        fill_range<float>(row_ptr, col, val, nrows, n_bc, kb,
                          (float*)blocks, bcols, g0, g1, stamp);
    });
  }
  for (auto& th : ths) th.join();
  return 0;
}

}  // extern "C"
