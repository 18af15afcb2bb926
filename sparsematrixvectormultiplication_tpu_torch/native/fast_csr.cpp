// fast_csr.cpp — native COO→CSR conversion (counting sort + per-row column
// sort). Re-design of the reference converter (src/csr_matrix.c:63-126:
// count → prefix → scatter → per-row quicksort), replacing the numpy
// np.lexsort path (O(nnz log nnz), single pass over 12+ B/entry keys) with
// an O(nnz) two-pass counting sort plus short per-row sorts. The same
// source as the JAX package's native/fast_csr.cpp.
//
// Exposed via ctypes: see native/build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// returns 0 on success; fills row_ptr (nrows+1), col_out, val_out (nnz).
// Entries within each row come out sorted by column (ties keep input order
// only within the sort's stability limits — duplicates are allowed upstream).
int64_t fast_coo_to_csr(const int32_t* row, const int32_t* col,
                        const double* val, int64_t nnz, int64_t nrows,
                        int num_threads, int64_t* row_ptr, int32_t* col_out,
                        double* val_out) {
  if (nnz < 0 || nrows < 0) return -1;

  // pass 1: histogram into row_ptr[1..nrows]
  std::memset(row_ptr, 0, sizeof(int64_t) * (size_t)(nrows + 1));
  for (int64_t e = 0; e < nnz; ++e) {
    int32_t r = row[e];
    if (r < 0 || r >= nrows) return -2;
    ++row_ptr[r + 1];
  }
  // prefix sum
  for (int64_t r = 0; r < nrows; ++r) row_ptr[r + 1] += row_ptr[r];

  // pass 2: scatter (stable within row: entries appear in input order)
  std::vector<int64_t> cur(row_ptr, row_ptr + nrows);
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t p = cur[row[e]]++;
    col_out[p] = col[e];
    val_out[p] = val[e];
  }

  // pass 3: per-row sort by column (vals follow). Rows are short for most
  // matrices; power-law rows can be long — std::sort on index permutation.
  auto sort_rows = [&](int64_t r0, int64_t r1) {
    std::vector<int32_t> perm;
    std::vector<int32_t> ctmp;
    std::vector<double> vtmp;
    for (int64_t r = r0; r < r1; ++r) {
      int64_t b = row_ptr[r], e = row_ptr[r + 1];
      int64_t n = e - b;
      if (n <= 1) continue;
      // fast path: already sorted (mtx files are usually row/col ordered)
      bool sorted = true;
      for (int64_t i = b + 1; i < e; ++i)
        if (col_out[i] < col_out[i - 1]) { sorted = false; break; }
      if (sorted) continue;
      if (n <= 32) {  // insertion sort, vals in lockstep
        for (int64_t i = b + 1; i < e; ++i) {
          int32_t c = col_out[i];
          double v = val_out[i];
          int64_t j = i - 1;
          while (j >= b && col_out[j] > c) {
            col_out[j + 1] = col_out[j];
            val_out[j + 1] = val_out[j];
            --j;
          }
          col_out[j + 1] = c;
          val_out[j + 1] = v;
        }
      } else {
        perm.resize(n);
        for (int64_t i = 0; i < n; ++i) perm[i] = (int32_t)i;
        std::sort(perm.begin(), perm.end(), [&](int32_t a, int32_t bb) {
          return col_out[b + a] < col_out[b + bb];
        });
        ctmp.resize(n);
        vtmp.resize(n);
        for (int64_t i = 0; i < n; ++i) {
          ctmp[i] = col_out[b + perm[i]];
          vtmp[i] = val_out[b + perm[i]];
        }
        std::memcpy(col_out + b, ctmp.data(), sizeof(int32_t) * (size_t)n);
        std::memcpy(val_out + b, vtmp.data(), sizeof(double) * (size_t)n);
      }
    }
  };

  int T = num_threads > 0 ? num_threads : 1;
  if (T <= 1 || nrows < 4096) {
    sort_rows(0, nrows);
  } else {
    std::vector<std::thread> ths;
    int64_t per = (nrows + T - 1) / T;
    for (int t = 0; t < T; ++t) {
      int64_t r0 = t * per, r1 = std::min(nrows, r0 + per);
      if (r0 < r1) ths.emplace_back(sort_rows, r0, r1);
    }
    for (auto& th : ths) th.join();
  }
  return 0;
}

}  // extern "C"
