// fast_mmio.cpp — multithreaded MatrixMarket coordinate-body parser.
//
// The hot loop of the Matrix Market reader (≙ the reference's C parser,
// src/matrix_parser.c:69-122, which fscanf's one triplet at a time). This
// implementation parses the whitespace table with a custom scanner, split
// across N threads at line boundaries, so 100M-nnz SuiteSparse files load
// at near-memory speed. The JAX package's native/fast_mmio.cpp with one
// change: values are converted by strtod (see scan_f64).
//
// Exposed via a C ABI consumed with ctypes: see native/build.py.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Fast integer scan; returns pointer past the number, or nullptr on error.
inline const char* scan_i64(const char* p, const char* end, int64_t* out) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end) return nullptr;
    bool neg = false;
    if (*p == '+' || *p == '-') { neg = (*p == '-'); ++p; }
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    *out = neg ? -v : v;
    return p;
}

// Floating-point scan covering the MatrixMarket reality:
// [+-]digits[.digits][eEdD[+-]digits]. The token is checked by hand (any
// other token, such as nan or inf, refuses the body) and converted by
// strtod, which rounds correctly, so values equal the numpy parser's. The
// JAX package's copy of this file accumulates an integer mantissa and
// scales it by a power of ten instead, which lands 1 ulp off on about a
// third of the 17-digit values write_matrix_market writes.
inline const char* scan_f64(const char* p, const char* end, double* out) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end) return nullptr;
    const char* tok = p;
    if (*p == '+' || *p == '-') ++p;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') { ++p; any = true; }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && *p >= '0' && *p <= '9') { ++p; any = true; }
    }
    if (!any) return nullptr;
    if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
        const char* q = p + 1;
        if (q < end && (*q == '+' || *q == '-')) ++q;
        bool edig = false;
        while (q < end && *q >= '0' && *q <= '9') { ++q; edig = true; }
        if (!edig) return nullptr;
        p = q;
    }
    char buf[128];  // strtod needs a terminated copy; Fortran d/D -> e
    const size_t n = size_t(p - tok);
    if (n >= sizeof(buf)) return nullptr;
    for (size_t i = 0; i < n; ++i)
        buf[i] = (tok[i] == 'd' || tok[i] == 'D') ? 'e' : tok[i];
    buf[n] = '\0';
    char* stop = nullptr;
    *out = std::strtod(buf, &stop);
    return stop == buf + n ? p : nullptr;
}

struct ChunkResult {
    int64_t parsed = 0;
    int error = 0;
};

void parse_chunk(const char* p, const char* end, int64_t start_idx, int64_t max_entries,
                 int32_t* rows, int32_t* cols, double* vals, int per_line,
                 ChunkResult* res) {
    int64_t i = start_idx;
    while (p < end && i < max_entries) {
        // skip whitespace/blank
        while (p < end && (unsigned char)*p <= ' ') ++p;
        if (p >= end) break;
        if (*p == '%') {  // stray comment line inside body
            while (p < end && *p != '\n') ++p;
            continue;
        }
        int64_t r, c;
        const char* q = scan_i64(p, end, &r);
        if (!q) { res->error = 1; return; }
        q = scan_i64(q, end, &c);
        if (!q) { res->error = 1; return; }
        double v = 1.0;
        if (per_line >= 3) {
            q = scan_f64(q, end, &v);
            if (!q) { res->error = 1; return; }
        }
        if (per_line >= 4) {  // complex: skip imaginary part (real kept)
            double im;
            q = scan_f64(q, end, &im);
            if (!q) { res->error = 1; return; }
        }
        rows[i] = (int32_t)r;
        cols[i] = (int32_t)c;
        if (vals) vals[i] = v;
        ++i;
        p = q;
    }
    res->parsed = i - start_idx;
}

// Count entries (lines with content) in [p, end) — used to pre-split work.
int64_t count_entries(const char* p, const char* end) {
    int64_t n = 0;
    while (p < end) {
        while (p < end && (unsigned char)*p <= ' ') ++p;
        if (p >= end) break;
        if (*p != '%') ++n;
        while (p < end && *p != '\n') ++p;
    }
    return n;
}

}  // namespace

extern "C" {

// Parse `nnz` coordinate entries from body[0:len].
// per_line: 2 = pattern, 3 = real/integer, 4 = complex (real part kept).
// rows/cols are 1-based as stored in the file (the Python layer converts).
// Returns number parsed, or -1 on malformed input.
int64_t fast_mmio_parse_body(const char* body, int64_t len, int64_t nnz,
                             int per_line, int num_threads,
                             int32_t* rows, int32_t* cols, double* vals) {
    const char* end = body + len;
    if (nnz <= 0) return 0;
    if (num_threads <= 1 || nnz < (1 << 16)) {
        ChunkResult res;
        parse_chunk(body, end, 0, nnz, rows, cols, vals, per_line, &res);
        return res.error ? -1 : res.parsed;
    }

    // split the byte range into num_threads chunks at line boundaries
    std::vector<const char*> starts(num_threads + 1);
    starts[0] = body;
    starts[num_threads] = end;
    for (int t = 1; t < num_threads; ++t) {
        const char* p = body + (len * t) / num_threads;
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
        starts[t] = p;
    }
    for (int t = 1; t < num_threads; ++t)
        if (starts[t] < starts[t - 1]) starts[t] = starts[t - 1];

    // first pass: count entries per chunk (cheap, memory-bound)
    std::vector<int64_t> counts(num_threads, 0);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < num_threads; ++t)
            th.emplace_back([&, t] { counts[t] = count_entries(starts[t], starts[t + 1]); });
        for (auto& x : th) x.join();
    }
    std::vector<int64_t> offs(num_threads + 1, 0);
    for (int t = 0; t < num_threads; ++t) offs[t + 1] = offs[t] + counts[t];
    if (offs[num_threads] < nnz) return -1;  // fewer entries than declared

    std::vector<ChunkResult> results(num_threads);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < num_threads; ++t) {
            int64_t lim = nnz < offs[t + 1] ? nnz : offs[t + 1];
            th.emplace_back([&, t, lim] {
                if (offs[t] >= lim) return;
                parse_chunk(starts[t], starts[t + 1], offs[t], lim,
                            rows, cols, vals, per_line, &results[t]);
            });
        }
        for (auto& x : th) x.join();
    }
    int64_t total = 0;
    for (int t = 0; t < num_threads; ++t) {
        if (results[t].error) return -1;
        total += results[t].parsed;
    }
    return total < nnz ? -1 : nnz;
}

}  // extern "C"
