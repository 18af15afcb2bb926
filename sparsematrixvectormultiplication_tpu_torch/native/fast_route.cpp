// Native router for the PR (permutation-routed) SpMV layout.
//
// Copied unchanged from sparsematrixvectormultiplication_tpu/native/
// fast_route.cpp (the port must not import the JAX package); built and
// loaded by this package's native/build.py.
//
// Computes, at conversion time, the device routing for formats/pr.py:
//   1. a proper 128-edge-coloring of the (src_row -> dst_row) bipartite
//      multigraph via Euler-split recursion (7 levels; every node has
//      degree exactly 128 on both sides), assigning each element its
//      routing lane;
//   2. per-lane Beneš swap masks (classic recursive looping algorithm)
//      bit-packed into one int32 plane (stage s = bit s, <= 31 stages);
//   3. the final per-destination-row lane-gather index table.
//
// Mirrors the pure-python reference in formats/pr_route.py (differential-
// tested); exists because the python router is O(n log n) interpreted —
// minutes at 4M elements vs ~a second here.
//
// Memory layout (v2): edges travel through the Euler-split levels as
// 16-byte records {src, dst, id<<7|dlane, color} that are PARTITIONED
// with their groups, so every level reads its group sequentially and the
// only random access is into node-indexed arrays (2*n_rows ints — cache
// resident), instead of chasing original edge ids across ~25 MB. Colors
// accumulate in-record (one scattered write at the end, not one per
// level), the Beneš phase consumes lane-bucketed records sequentially,
// and the packed-mask planes are assembled lane-major then block-
// transposed. ~2.3x end-to-end vs v1 on the 1-core build VM (926k-entry
// powerlaw: 3.3 s -> 1.4 s router time).
//
// ctypes ABI (see native/build.py):
//   int pr_route(int64_t n, int64_t n_rows,
//                const int32_t* src_row, const int32_t* dst_row,
//                const int32_t* dst_lane,
//                int32_t* src_lane,        // (n,) out
//                int32_t* packed_masks,    // (n_rows*128,) out
//                int32_t* final_lane)      // (n_rows*128,) out
// returns 0 on success.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kLanes = 128;

// Edge record carried through the Euler-split partition levels. id and
// dst_lane share one int32 (id = n <= 2^23 padded elements, lane < 128),
// keeping the record a power-of-two 16 bytes so a trail-walk step costs
// one cache line.
struct Edge {
  int32_t sr;        // source row (left node)
  int32_t dr;        // dest row (right node)
  int32_t idl;       // (original element id << 7) | dst_lane
  int32_t color;     // routing-lane bits accumulated per level
};

// ---------------------------------------------------------------------------
// Euler-split edge coloring
// ---------------------------------------------------------------------------

// Split the multigraph edges[0..m) (all degrees even) into two halves by
// walking closed trails; writes side bit (0/1) per edge into `side`.
// Nodes: edges[i].sr on the left, n_rows + edges[i].dr on the right.
void euler_split(const Edge* edges, int64_t m, int64_t n_rows,
                 std::vector<int32_t>& ptr, std::vector<int32_t>& inc,
                 std::vector<int32_t>& cursor, std::vector<uint8_t>& used,
                 uint8_t* side) {
  const int64_t n_nodes = 2 * n_rows;
  // build incidence (each edge appears at both endpoints, by LOCAL index)
  std::fill(ptr.begin(), ptr.begin() + n_nodes + 1, 0);
  for (int64_t i = 0; i < m; ++i) {
    ++ptr[edges[i].sr + 1];
    ++ptr[n_rows + edges[i].dr + 1];
  }
  for (int64_t v = 0; v < n_nodes; ++v) ptr[v + 1] += ptr[v];
  for (int64_t i = 0; i < m; ++i) {
    inc[ptr[edges[i].sr]++] = i;
    inc[ptr[n_rows + edges[i].dr]++] = i;
  }
  // ptr now shifted by one position; restore
  for (int64_t v = n_nodes; v > 0; --v) ptr[v] = ptr[v - 1];
  ptr[0] = 0;

  std::copy(ptr.begin(), ptr.begin() + n_nodes, cursor.begin());
  std::fill(used.begin(), used.begin() + m, 0);

  for (int64_t start = 0; start < m; ++start) {
    if (used[start]) continue;
    int64_t i = start;
    int64_t node = edges[start].sr;
    for (;;) {
      used[i] = 1;
      if (node == edges[i].sr) {            // traversed L -> R
        side[i] = 0;
        node = n_rows + edges[i].dr;
      } else {                              // R -> L
        side[i] = 1;
        node = edges[i].sr;
      }
      int64_t c = cursor[node];
      const int64_t stop = ptr[node + 1];
      while (c < stop && used[inc[c]]) ++c;
      cursor[node] = c;
      if (c == stop) break;                 // trail closed
      i = inc[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Beneš routing (per lane)
// ---------------------------------------------------------------------------

struct Benes {
  // int32 scratch throughout: n_rows <= 2^16 and edge ids <= 2^23, so
  // narrow types halve the random-access cache footprint (this runs on a
  // single core; memory behavior IS the runtime)
  int64_t n, p, n_stages;
  std::vector<int32_t> inv, lo_perm, hi_perm;
  std::vector<int8_t> sub;
  int32_t* packed;  // (n,) int32 — bit s = stage s swap bit at this row

  explicit Benes(int64_t n_) : n(n_) {
    p = 0;
    while ((int64_t(1) << p) < n) ++p;
    n_stages = 2 * p - 1;
    inv.resize(n);
    sub.resize(n);
    lo_perm.resize(n);
    hi_perm.resize(n);
  }

  // route sigma over positions [base, base+size), writing swap bits at
  // stage `level` (input) and n_stages-1-level (output) for those rows.
  // sigma/scratch live in caller-provided arrays indexed [0, size).
  void route(int level, int64_t base, int64_t size, int32_t* sigma) {
    if (size == 2) {
      const int s = int(p - 1);
      if (sigma[0] == 1) {
        packed[base] |= (1 << s);
        packed[base + 1] |= (1 << s);
      }
      return;
    }
    const int64_t h = size / 2;
    const int s_in = level;
    const int s_out = int(n_stages - 1 - level);
    int32_t* invp = inv.data() + base;
    int8_t* subp = sub.data() + base;
    for (int64_t i = 0; i < size; ++i) invp[sigma[i]] = i;
    std::memset(subp, -1, size);
    for (int64_t seed = 0; seed < size; ++seed) {
      if (subp[seed] >= 0) continue;
      int64_t e = seed;
      int8_t s = 0;
      while (subp[e] < 0) {
        subp[e] = s;
        const int64_t e2 = e ^ h;           // input-pair partner
        if (subp[e2] < 0) subp[e2] = 1 - s;
        e = invp[sigma[e2] ^ h];            // e2's output-pair partner
      }
    }
    // swap bits: a[P] = subnet of elem at input P (<h), mirrored at P+h;
    // b[Q] = subnet of elem with OUTPUT position Q (<h)
    for (int64_t q = 0; q < h; ++q) {
      if (subp[q]) {
        packed[base + q] |= (1 << s_in);
        packed[base + q + h] |= (1 << s_in);
      }
      if (subp[invp[q]]) {
        packed[base + q] |= (1 << s_out);
        packed[base + q + h] |= (1 << s_out);
      }
    }
    // sub-permutations over mid slots (overwrite into lo/hi scratch then
    // copy back into sigma's halves so recursion can reuse the buffer)
    int32_t* lo = lo_perm.data() + base;
    int32_t* hi = hi_perm.data() + base;
    for (int64_t e = 0; e < size; ++e) {
      const int64_t slot = e % h;
      const int32_t out = int32_t(sigma[e] % h);
      if (subp[e] == 0)
        lo[slot] = out;
      else
        hi[slot] = out;
    }
    std::memcpy(sigma, lo, sizeof(int32_t) * h);
    std::memcpy(sigma + h, hi, sizeof(int32_t) * h);
    route(level + 1, base, h, sigma);
    route(level + 1, base + h, h, sigma + h);
  }
};

}  // namespace

extern "C" int pr_route(int64_t n, int64_t n_rows, const int32_t* src_row,
                        const int32_t* dst_row, const int32_t* dst_lane,
                        int32_t* src_lane, int32_t* packed_masks,
                        int32_t* final_lane) {
  if (n != n_rows * kLanes) return 1;
  // power-of-two check + stage-count cap (31 bits)
  if (n_rows < 2 || (n_rows & (n_rows - 1)) != 0) return 2;
  int64_t p = 0;
  while ((int64_t(1) << p) < n_rows) ++p;
  if (2 * p - 1 > 31) return 3;

  // ---- 1. edge coloring (7 Euler-split levels over partitioned records)
  std::vector<Edge> edges(n), next_edges(n);
  for (int64_t e = 0; e < n; ++e)
    edges[e] = Edge{src_row[e], dst_row[e],
                    int32_t((e << 7) | dst_lane[e]), 0};
  std::vector<int64_t> group_ptr = {0, n}, next_ptr;
  std::vector<int32_t> ptr(2 * n_rows + 1), inc(2 * n), cursor(2 * n_rows);
  std::vector<uint8_t> used(n), side(n);

  for (int level = 0; level < 7; ++level) {
    next_ptr.clear();
    next_ptr.push_back(0);
    int64_t w = 0;
    for (size_t g = 0; g + 1 < group_ptr.size(); ++g) {
      const int64_t lo = group_ptr[g], hi = group_ptr[g + 1];
      const int64_t m = hi - lo;
      euler_split(edges.data() + lo, m, n_rows, ptr, inc, cursor, used,
                  side.data());
      // stable partition (side 0 first), accumulating color bits in-record
      for (int64_t i = 0; i < m; ++i)
        if (!side[i]) {
          Edge ed = edges[lo + i];
          ed.color <<= 1;
          next_edges[w++] = ed;
        }
      next_ptr.push_back(w);
      for (int64_t i = 0; i < m; ++i)
        if (side[i]) {
          Edge ed = edges[lo + i];
          ed.color = (ed.color << 1) | 1;
          next_edges[w++] = ed;
        }
      next_ptr.push_back(w);
    }
    edges.swap(next_edges);
    group_ptr.swap(next_ptr);
  }
  // one scattered pass writes the per-element routing lane (vs one per
  // level in v1)
  for (int64_t i = 0; i < n; ++i)
    src_lane[edges[i].idl >> 7] = edges[i].color;

  // ---- 2. per-lane Beneš masks
  // bucket records by color (counting sort into the spare record buffer)
  {
    std::vector<int64_t> cnt(kLanes + 1, 0);
    for (int64_t i = 0; i < n; ++i) ++cnt[edges[i].color + 1];
    for (int c = 0; c < kLanes; ++c) cnt[c + 1] += cnt[c];
    for (int64_t i = 0; i < n; ++i) next_edges[cnt[edges[i].color]++] = edges[i];
    edges.swap(next_edges);
  }
  // lanes are independent: thread the per-lane Beneš routing. Each lane
  // reads its record slice sequentially; sigma / lane_packed (n_rows
  // int32) stay cache-resident. Planes land lane-major in all_packed and
  // are block-transposed into the row-major output at the end.
  std::vector<int32_t> all_packed(int64_t(kLanes) * n_rows);
  const unsigned hw = std::thread::hardware_concurrency();
  const int n_threads = int(hw ? (hw < 16 ? hw : 16) : 4);
  std::atomic<int> next_lane{0};
  auto worker = [&]() {
    std::vector<int32_t> sigma(n_rows);
    Benes benes(n_rows);
    for (;;) {
      const int lane = next_lane.fetch_add(1);
      if (lane >= kLanes) break;
      const Edge* recs = edges.data() + int64_t(lane) * n_rows;
      for (int64_t i = 0; i < n_rows; ++i) {
        const Edge& ed = recs[i];
        sigma[ed.sr] = ed.dr;
        // final gather: dest row ed.dr wants its dest-lane (idl & 127)
        // served from routing lane `lane` (each (row, dlane) slot written
        // by exactly one lane — no races)
        final_lane[int64_t(ed.dr) * kLanes + (ed.idl & 127)] = lane;
      }
      int32_t* lane_packed = all_packed.data() + int64_t(lane) * n_rows;
      // all_packed is zero-initialised; route() only ORs bits in
      benes.packed = lane_packed;
      benes.route(0, 0, n_rows, sigma.data());
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();

  // blocked transpose (kLanes, n_rows) -> (n_rows, kLanes): each 64-row
  // output tile (32 KB) stays cache-resident across the 128 lane columns
  constexpr int64_t kBlockRows = 64;
  for (int64_t r0 = 0; r0 < n_rows; r0 += kBlockRows) {
    const int64_t rmax =
        (n_rows - r0) < kBlockRows ? (n_rows - r0) : kBlockRows;
    for (int lane = 0; lane < kLanes; ++lane) {
      const int32_t* src = all_packed.data() + int64_t(lane) * n_rows + r0;
      for (int64_t r = 0; r < rmax; ++r)
        packed_masks[(r0 + r) * kLanes + lane] = src[r];
    }
  }
  return 0;
}
