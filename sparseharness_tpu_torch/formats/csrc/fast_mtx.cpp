// Fast MatrixMarket coordinate-body parser.
//
// Native counterpart of the reference's C parser stack (src/mmio.cpp NIST
// reader + the fscanf entry loop in src/sparse_matrix.cpp:50-62), redesigned
// for throughput: one read of the whole body, branch-light inline integer /
// float scanning, no per-line stdio. Exposed as a C ABI consumed from Python
// via ctypes (formats/native_io.py); the NumPy path remains the behavioural
// reference and fallback.
//
// Build: native/Makefile -> libfastmtx.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <memory>
#include <vector>

namespace {

inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

inline const char *parse_i32(const char *p, const char *end, int32_t *out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  int64_t v = 0;
  const char *start = p;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  if (p == start) return nullptr;
  *out = static_cast<int32_t>(neg ? -v : v);
  return p;
}

// Fast decimal float: mantissa/exponent scan; falls back to strtod for
// anything unusual (hex, inf, nan) to stay bit-compatible with libc.
inline const char *parse_f64(const char *p, const char *end, double *out) {
  p = skip_ws(p, end);
  const char *start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  int64_t mant = 0;
  int digits = 0, frac = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9' && digits < 18) {
    mant = mant * 10 + (*p - '0');
    ++digits;
    ++p;
    any = true;
  }
  if (digits >= 18) {  // precision edge: defer to strtod
    char *e;
    *out = strtod(start, &e);
    return e > start ? e : nullptr;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      if (digits < 18) {
        mant = mant * 10 + (*p - '0');
        ++digits;
        ++frac;
      }
      ++p;
      any = true;
    }
  }
  if (!any) return nullptr;
  int exp10 = 0;
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int ev = 0;
    const char *estart = p;
    while (p < end && *p >= '0' && *p <= '9') {
      ev = ev * 10 + (*p - '0');
      ++p;
    }
    if (p == estart) return nullptr;
    exp10 = eneg ? -ev : ev;
  }
  static const double pow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,
                                 1e7,  1e8,  1e9,  1e10, 1e11, 1e12, 1e13,
                                 1e14, 1e15, 1e16, 1e17, 1e18};
  int e = exp10 - frac;
  if (digits > 15 || e < -18 || e > 18) {
    // >15 digits: mant may exceed 2^53, so double(mant) already rounded
    // and the scale step would double-round (1 ulp off vs libc on %.17g
    // round-trip files). ≤15 digits + one exact pow10 op is the standard
    // single-rounding exactness criterion; defer the rest to strtod.
    // (strtod re-reads from `start`, sign included — do NOT re-negate.)
    char *endp;
    *out = strtod(start, &endp);
    return endp > start ? endp : nullptr;
  }
  double v = static_cast<double>(mant);
  v = e >= 0 ? v * pow10[e] : v / pow10[-e];
  *out = neg ? -v : v;
  return p;
}

}  // namespace

extern "C" {

// Parse `nnz` coordinate entries starting at byte `offset` of `path`.
// pattern != 0 -> two columns (values filled with 1.0).
// rows/cols are 0-based on output. Returns number parsed, or -errno-ish:
//   -1 file open/read failure, -2 malformed entry.
int64_t fastmtx_parse(const char *path, int64_t offset, int64_t nnz,
                      int pattern, int32_t *rows, int32_t *cols,
                      double *vals) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  if (offset > size) {
    fclose(f);
    return -1;
  }
  fseek(f, offset, SEEK_SET);
  long body = size - offset;
  char *buf = static_cast<char *>(malloc(body + 1));
  if (!buf) {
    fclose(f);
    return -1;
  }
  long got = static_cast<long>(fread(buf, 1, body, f));
  fclose(f);
  buf[got] = '\0';
  const char *p = buf;
  const char *end = buf + got;
  int64_t i = 0;
  for (; i < nnz; ++i) {
    int32_t r, c;
    p = parse_i32(p, end, &r);
    if (!p) break;
    p = parse_i32(p, end, &c);
    if (!p) break;
    double v = 1.0;
    if (!pattern) {
      p = parse_f64(p, end, &v);
      if (!p) break;
    }
    rows[i] = r - 1;
    cols[i] = c - 1;
    vals[i] = v;
  }
  free(buf);
  return i;
}

// Row-sorted CSR encode: counts + prefix sum + stable scatter.
// Native counterpart of calculate_ellpack's histogram+fill
// (src/sparse_matrix.cpp:72-120) without the byte packing.
void fastmtx_csr_encode(int64_t nnz, int32_t n_rows, const int32_t *rows,
                        const int32_t *cols, const double *vals,
                        int32_t *indptr /* n_rows+1 */,
                        int32_t *out_cols /* nnz */,
                        float *out_vals /* nnz */) {
  memset(indptr, 0, sizeof(int32_t) * (n_rows + 1));
  for (int64_t i = 0; i < nnz; ++i) ++indptr[rows[i] + 1];
  for (int32_t r = 0; r < n_rows; ++r) indptr[r + 1] += indptr[r];
  int32_t *cursor = static_cast<int32_t *>(
      malloc(sizeof(int32_t) * n_rows));
  memcpy(cursor, indptr, sizeof(int32_t) * n_rows);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t at = cursor[rows[i]]++;
    out_cols[at] = cols[i];
    out_vals[at] = static_cast<float>(vals[i]);
  }
  free(cursor);
}

}  // extern "C"

// ---------------------------------------------------------------- RCM
// Native reverse Cuthill-McKee over a symmetrized, de-duplicated,
// diagonal-free CSR pattern. Bit-identical ordering to the NumPy
// reference (formats/reorder.py rcm_permutation): seeds in stable
// (degree, id) order, George-Liu pseudo-peripheral refinement, and
// within a BFS level nodes grouped by first-discovering parent and
// sorted by (degree, id). The traversal is the Python-loop-bound part
// of RCM; everything around it stays vectorized NumPy.

namespace {

struct BfsScratch {
  std::vector<int32_t> stamp;   // epoch-stamped "seen" (no per-call memset)
  std::vector<int32_t> frontier, next;
  int32_t epoch = 0;
};

// Level BFS from seed avoiding `visited`; returns eccentricity and sets
// *cand to the min-(degree, id) node of the deepest level.
static int32_t bfs_ecc(int32_t seed, const int32_t *indptr,
                       const int32_t *indices, const int32_t *deg,
                       const uint8_t *visited, BfsScratch &s,
                       int32_t *cand) {
  const int32_t epoch = ++s.epoch;
  s.frontier.clear();
  s.frontier.push_back(seed);
  s.stamp[seed] = epoch;
  int32_t ecc = 0;
  for (;;) {
    s.next.clear();
    for (int32_t u : s.frontier) {
      for (int32_t j = indptr[u]; j < indptr[u + 1]; ++j) {
        int32_t v = indices[j];
        if (s.stamp[v] == epoch || visited[v]) continue;
        s.stamp[v] = epoch;
        s.next.push_back(v);
      }
    }
    if (s.next.empty()) break;
    s.frontier.swap(s.next);
    ++ecc;
  }
  int32_t best = s.frontier[0];
  for (int32_t u : s.frontier) {
    if (deg[u] < deg[best] || (deg[u] == deg[best] && u < best)) best = u;
  }
  *cand = best;
  return ecc;
}

}  // namespace

extern "C" {

// Symmetrized, de-duplicated, diagonal-free CSR pattern from COO edges:
// the RCM preprocessing step (NumPy reference: reorder._sym_pattern_csr).
// indices_out must have room for 2*nnz entries; returns the symmetrized
// count, or -1 on allocation failure. Counting-sort by row then per-row
// sort+unique — O(nnz log deg) instead of one global O(nnz log nnz) sort.
int64_t fastmtx_sym_pattern(int32_t n, int64_t nnz, const int32_t *rows,
                            const int32_t *cols, int32_t *indptr_out,
                            int32_t *indices_out) try {
  std::vector<int64_t> count(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    if (rows[i] == cols[i]) continue;
    ++count[rows[i] + 1];
    ++count[cols[i] + 1];
  }
  for (int32_t r = 0; r < n; ++r) count[r + 1] += count[r];
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  std::vector<int32_t> scratch(count[n]);
  for (int64_t i = 0; i < nnz; ++i) {
    if (rows[i] == cols[i]) continue;
    scratch[cursor[rows[i]]++] = cols[i];
    scratch[cursor[cols[i]]++] = rows[i];
  }
  int64_t out = 0;
  indptr_out[0] = 0;
  for (int32_t r = 0; r < n; ++r) {
    int32_t *b = scratch.data() + count[r];
    int32_t *e = scratch.data() + count[r + 1];
    std::sort(b, e);
    int32_t prev = -1;
    for (int32_t *p = b; p < e; ++p) {
      if (*p != prev) {
        indices_out[out++] = *p;
        prev = *p;
      }
    }
    indptr_out[r + 1] = static_cast<int32_t>(out);
  }
  return out;
} catch (...) {
  return -1;
}

// perm[i] = old index of new row i (new -> old), already reversed.
void fastmtx_rcm(int32_t n, const int32_t *indptr, const int32_t *indices,
                 int32_t *perm) {
  if (n <= 0) return;
  std::vector<int32_t> deg(n);
  for (int32_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];

  // stable counting sort of nodes by degree (np.argsort kind="stable")
  int32_t max_deg = 0;
  for (int32_t i = 0; i < n; ++i) max_deg = std::max(max_deg, deg[i]);
  std::vector<int32_t> count(max_deg + 2, 0), seeds(n);
  for (int32_t i = 0; i < n; ++i) ++count[deg[i] + 1];
  for (int32_t d = 0; d <= max_deg; ++d) count[d + 1] += count[d];
  for (int32_t i = 0; i < n; ++i) seeds[count[deg[i]]++] = i;

  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  BfsScratch scratch;
  scratch.stamp.assign(n, 0);
  std::vector<int32_t> nbrs;

  for (int32_t si = 0; si < n; ++si) {
    int32_t s = seeds[si];
    if (visited[s]) continue;
    if (deg[s] > 0) {
      // George-Liu: re-seed at the deepest level's min-degree node until
      // the eccentricity stops growing (<= 4 sweeps) — mirrors the NumPy
      // _pseudo_peripheral control flow exactly.
      int32_t cand;
      int32_t ecc = bfs_ecc(s, indptr, indices, deg.data(), visited.data(),
                            scratch, &cand);
      for (int sweep = 0; sweep < 4; ++sweep) {
        int32_t ecc2 = bfs_ecc(s, indptr, indices, deg.data(),
                               visited.data(), scratch, &cand);
        if (ecc2 <= ecc && cand != s && ecc2 < ecc) break;
        int32_t cand2;
        int32_t ecc_c = bfs_ecc(cand, indptr, indices, deg.data(),
                                visited.data(), scratch, &cand2);
        if (ecc_c <= ecc2) break;
        s = cand;
        ecc = ecc_c;
      }
    }
    // Cuthill-McKee from s: queue order == level order grouped by
    // first-discovering parent; each parent's new neighbours append
    // sorted by (degree, id).
    visited[s] = 1;
    size_t head = order.size();
    order.push_back(s);
    while (head < order.size()) {
      int32_t u = order[head++];
      nbrs.clear();
      for (int32_t j = indptr[u]; j < indptr[u + 1]; ++j) {
        int32_t v = indices[j];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
        return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
      });
      order.insert(order.end(), nbrs.begin(), nbrs.end());
    }
  }
  for (int32_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// Two-shelf interval packer for the sell2 builder — the native
// counterpart of ops/pallas_sell2.py:_twoshelf_pack, bit-identical by
// construction (same stable demand-desc order, hole policy, first-free
// ascending pile placement) so the Python and native paths produce the
// same layout. The packer is ~58% of sell2 build time in NumPy; the
// encode path is the reference's native layer (src/sparse_matrix.cpp
// cl_encode), so it is native here too.
//
// cnt:      nb x 128 per-(block, row-lane) pile heights, row-major
// bind0/1:  cap entries (cap = sum(max-lane demand) + max_push + 1),
//           per-sublane block id per shelf, -1 = uncovered
// way:      nb, shelf bit per block
// flat_sub: sum(cnt) sublane ids in (block, lane, pile-pos) order
// returns n_sub (sublanes used)
void sell2_twoshelf_pack(const int64_t *cnt, int64_t nb, int64_t max_push,
                         int64_t max_holes, int64_t hole_tries,
                         int64_t *bind0, int64_t *bind1, int8_t *way,
                         int64_t *flat_sub, int64_t *n_sub_out) {
  const int L = 128;
  std::vector<int64_t> demand(nb);
  int64_t dsum = 0;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t d = 0;
    for (int l = 0; l < L; ++l) d = std::max(d, cnt[b * L + l]);
    demand[b] = d;
    dsum += d;
  }
  std::vector<int64_t> order;
  order.reserve(nb);
  for (int64_t b = 0; b < nb; ++b)
    if (demand[b] > 0) order.push_back(b);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return demand[a] > demand[b];
  });
  const int64_t cap = dsum + max_push + 1;
  // lane-major occupancy BITSETS (r5): fits() was the packer hot spot —
  // per probe it walked d rows × 128 lanes of a row-major byte array
  // (stride-128, cache-hostile). Lane-major uint64 words turn the
  // per-lane free count into popcounts over ~d/64 words, and place()
  // into ctz iteration over free-bit masks; decisions and placement
  // order are unchanged, so the layout stays bit-identical.
  const int64_t words = (cap + 63) >> 6;
  std::vector<uint64_t> bits((size_t)L * words, 0);
  std::fill(bind0, bind0 + cap, (int64_t)-1);
  std::fill(bind1, bind1 + cap, (int64_t)-1);
  std::fill(way, way + nb, (int8_t)0);
  std::vector<int64_t> pstart((size_t)nb * L + 1, 0);
  for (int64_t i = 0; i < nb * L; ++i) pstart[i + 1] = pstart[i] + cnt[i];

  // popcount of occupied bits in [b0, b1) of one lane's bitset
  auto count_occ = [](const uint64_t *bw, int64_t b0, int64_t b1) {
    const int64_t w0 = b0 >> 6, w1 = (b1 - 1) >> 6;
    const uint64_t m0 = ~0ULL << (b0 & 63);
    const uint64_t m1 = ~0ULL >> (63 - ((b1 - 1) & 63));
    if (w0 == w1) return (int64_t)__builtin_popcountll(bw[w0] & m0 & m1);
    int64_t c = __builtin_popcountll(bw[w0] & m0);
    for (int64_t w = w0 + 1; w < w1; ++w)
      c += __builtin_popcountll(bw[w]);
    return c + (int64_t)__builtin_popcountll(bw[w1] & m1);
  };
  auto fits = [&](int64_t o, int64_t d, const int64_t *h) {
    for (int l = 0; l < L; ++l) {
      if (!h[l]) continue;
      if (d - count_occ(&bits[(size_t)l * words], o, o + d) < h[l])
        return false;
    }
    return true;
  };
  auto place = [&](int64_t bi, int sh, int64_t o, int64_t d) {
    const int64_t *h = cnt + bi * L;
    for (int l = 0; l < L; ++l) {
      int64_t need = h[l];
      if (!need) continue;
      uint64_t *bw = &bits[(size_t)l * words];
      int64_t *dst = flat_sub + pstart[bi * L + l];
      const int64_t b1 = o + d;
      const int64_t w0 = o >> 6, w1 = (b1 - 1) >> 6;
      for (int64_t w = w0; w <= w1 && need; ++w) {
        uint64_t m = ~bw[w];
        if (w == w0) m &= ~0ULL << (o & 63);
        if (w == w1) m &= ~0ULL >> (63 - ((b1 - 1) & 63));
        while (m && need) {
          const int b = __builtin_ctzll(m);
          bw[w] |= 1ULL << b;
          *dst++ = (w << 6) + b;
          m &= m - 1;
          --need;
        }
      }
    }
    int64_t *bd = sh == 0 ? bind0 : bind1;
    for (int64_t r = o; r < o + d; ++r) bd[r] = bi;
    way[bi] = (int8_t)sh;
  };

  int64_t frontier[2] = {0, 0};
  std::vector<std::pair<int64_t, int64_t>> holes[2];
  for (int64_t bi : order) {
    const int64_t *h = cnt + bi * L;
    const int64_t d = demand[bi];
    bool placed = false;
    for (int sh = 0; sh < 2 && !placed; ++sh) {
      auto &hl = holes[sh];
      for (size_t k = 0; k < hl.size(); ++k) {
        const int64_t h0 = hl[k].first, h1 = hl[k].second;
        if (h1 - h0 < d) continue;
        int64_t o = h0, tries = 0;
        bool found = false;
        while (o + d <= h1 && tries < hole_tries) {
          if (fits(o, d, h)) {
            found = true;
            break;
          }
          ++o;
          ++tries;
        }
        if (!found) continue;
        if (o + d > cap) {  // provably unreachable (holes ⊂ old ground);
          *n_sub_out = -1;  // guarded anyway: a breach would corrupt heap
          return;
        }
        place(bi, sh, o, d);
        std::vector<std::pair<int64_t, int64_t>> repl;
        if (o > h0) repl.push_back({h0, o});
        if (o + d < h1) repl.push_back({o + d, h1});
        hl.erase(hl.begin() + k);
        hl.insert(hl.begin() + k, repl.begin(), repl.end());
        placed = true;
        break;
      }
    }
    if (placed) continue;
    const int sh = frontier[0] <= frontier[1] ? 0 : 1;
    int64_t o = frontier[sh], pushes = 0;
    bool found = false;
    while (pushes < max_push) {
      if (fits(o, d, h)) {
        found = true;
        break;
      }
      ++o;
      ++pushes;
    }
    if (!found) o = std::max(frontier[0], frontier[1]);
    // invariant: frontiers only ever total ≤ Σ(other demands) = dsum − d,
    // so o + d ≤ dsum + max_push < cap (cap = dsum + max_push + 1). A
    // breach would be silent heap corruption → hard error the wrapper
    // turns into NativeUnavailable (ADVICE r4)
    if (o + d > cap) {
      *n_sub_out = -1;
      return;
    }
    if (o > frontier[sh] && (int64_t)holes[sh].size() < max_holes)
      holes[sh].push_back({frontier[sh], o});
    place(bi, sh, o, d);
    frontier[sh] = o + d;
  }
  *n_sub_out = std::max(frontier[0], frontier[1]);
}

}  // extern "C"

// ===================================================================
// sell2 native encode core (r5): the per-slab phase A/B + array fills of
// ops/pallas_sell2.build_sell2, bit-identical to the NumPy path (which
// remains the behavioural definition and fallback — tests assert array
// equality). The encode layer is native in the reference too
// (src/sparse_matrix.cpp cl_encode); at 1.7M nnz the NumPy glue ran
// ~1.2 Mnnz/s dominated by sorts/histograms/scatters — this core replaces
// them with counting/radix passes. Stage names below mirror the NumPy
// sections; every sort is stable with the same key order as the
// corresponding np.lexsort/np.argsort call.
// ===================================================================

namespace {

constexpr int kL = 128;
constexpr int kUsable = 127;
constexpr int64_t kSlabRows = 2 * 128 * 128;
constexpr int64_t kAlignBudget = 254;

struct Sell2Slab {
  int64_t P = 0;
  int64_t n_virt = 0;
  int32_t bf_depth = 1, two_tiles = 0, has_hi = 0;
  std::vector<int32_t> wordA, wordB;    // P*128 x 128 row-major
  std::vector<uint8_t> vals;            // P*128*128 * itemsize
  std::vector<int32_t> chunk_of_panel;  // P x 2
  std::vector<int32_t> p_depth;         // P
  std::vector<uint8_t> p_two, p_hi;     // P
  std::vector<int32_t> virt_rows;       // n_virt x 128
};

inline int64_t next_pow2_i(int64_t k) {
  if (k <= 1) return 1;
  return int64_t(1) << (64 - __builtin_clzll((uint64_t)(k - 1)));
}

inline int level_of_pow2(int64_t w) {  // w in {1..128} -> 0..7
  return 63 - __builtin_clzll((uint64_t)w);
}

// stage clocks (SELL2_NATIVE_TIMINGS=1 -> per-stage ms on stderr)
struct StageClock {
  bool on;
  double t0;
  StageClock() {
    on = getenv("SELL2_NATIVE_TIMINGS") != nullptr;
    t0 = now();
  }
  static double now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  }
  void mark(const char *name) {
    if (!on) return;
    double t = now();
    fprintf(stderr, "[sell2-native] %-12s %7.2f ms\n", name,
            (t - t0) * 1e3);
    t0 = t;
  }
};

}  // namespace

extern "C" {

// Encode one row slab. Inputs are the slab's entries in build order
// (rows local to the slab). Returns an opaque handle (query via
// sell2_slab_meta, copy out via sell2_slab_fetch, release via
// sell2_slab_free) or NULL when a layout invariant fails (caller falls
// back to the NumPy path).
void *sell2_encode_slab(
    const int64_t *rows_e, const int64_t *cols_e, const uint8_t *vals_e,
    int64_t m, int64_t itemsize, const uint8_t *zero_bytes,
    int64_t n_chunks, int64_t virt_base, int64_t rows_slab,
    int32_t virtual_chunks_on, int64_t max_push, int64_t max_holes,
    int64_t hole_tries, int64_t virt_demand_t) {
  (void)n_chunks;  // virtual ids are based at virt_base (passed in)
  if (m <= 0) return nullptr;
  std::unique_ptr<Sell2Slab> out(new Sell2Slab);
  StageClock ck;

  // ---- per-entry lane / chunk / blk / col_lane ----------------------
  std::vector<int32_t> lane(m), col_lane(m);
  std::vector<int32_t> chunk(m), blkc(m);
  for (int64_t i = 0; i < m; ++i) {
    lane[i] = (int32_t)(rows_e[i] & (kL - 1));
    col_lane[i] = (int32_t)(cols_e[i] & (kL - 1));
    chunk[i] = (int32_t)(cols_e[i] >> 14);  // / (128*128)
    blkc[i] = (int32_t)((cols_e[i] >> 7) & (kL - 1));
  }

  ck.mark("lanes");
  // ---- virtual chunks ----------------------------------------------
  // mirror: gbu = sorted unique global block ids, per-block lane demand,
  // per-chunk demand, light blocks dealt demand-desc round-robin into
  // pools of <=128 (np.argsort(-dem, stable) then stable sort by k%npools)
  if (virtual_chunks_on) {
    std::vector<int64_t> gb(m);
    for (int64_t i = 0; i < m; ++i) gb[i] = cols_e[i] >> 7;
    // dense map over present blocks (ascending == np.unique order)
    std::vector<int64_t> gbu;
    std::vector<int32_t> gbi(m);
    const int64_t gb_range = n_chunks * kL;
    if (gb_range <= (int64_t)1 << 22) {
      // presence bitmap + prefix over the block-id range replaces the
      // full-entry sort/unique (that sort was ~half the virtual stage);
      // the same table then maps entries in O(1)
      std::vector<int32_t> lut(gb_range, -1);
      for (int64_t i = 0; i < m; ++i) lut[gb[i]] = 1;
      for (int64_t b = 0; b < gb_range; ++b)
        if (lut[b] >= 0) {
          lut[b] = (int32_t)gbu.size();
          gbu.push_back(b);
        }
      for (int64_t i = 0; i < m; ++i) gbi[i] = lut[gb[i]];
    } else {
      gbu = gb;
      std::sort(gbu.begin(), gbu.end());
      gbu.erase(std::unique(gbu.begin(), gbu.end()), gbu.end());
      for (int64_t i = 0; i < m; ++i)
        gbi[i] = (int32_t)(std::lower_bound(gbu.begin(), gbu.end(), gb[i]) -
                           gbu.begin());
    }
    const int64_t nbu = (int64_t)gbu.size();
    std::vector<int32_t> cnt_b((size_t)nbu * kL, 0);
    for (int64_t i = 0; i < m; ++i) ++cnt_b[(size_t)gbi[i] * kL + lane[i]];
    std::vector<int64_t> dem_b(nbu, 0);
    for (int64_t b = 0; b < nbu; ++b) {
      int32_t d = 0;
      const int32_t *row = &cnt_b[(size_t)b * kL];
      for (int l = 0; l < kL; ++l) d = std::max(d, row[l]);
      dem_b[b] = d;
    }
    // per-chunk demand over a dense map of present chunks
    std::vector<int64_t> chu(nbu);
    for (int64_t b = 0; b < nbu; ++b) chu[b] = gbu[b] >> 7;
    std::vector<int64_t> chu_u(chu);
    chu_u.erase(std::unique(chu_u.begin(), chu_u.end()), chu_u.end());
    std::vector<int64_t> dem_c(chu_u.size(), 0);
    std::vector<int32_t> chui(nbu);
    for (int64_t b = 0; b < nbu; ++b) {
      chui[b] = (int32_t)(std::lower_bound(chu_u.begin(), chu_u.end(),
                                           chu[b]) - chu_u.begin());
      dem_c[chui[b]] += dem_b[b];
    }
    std::vector<int64_t> lb;
    std::vector<uint8_t> light_chunk_seen(chu_u.size(), 0);
    int64_t n_light_chunks = 0;
    for (int64_t b = 0; b < nbu; ++b)
      if (dem_c[chui[b]] <= virt_demand_t) {
        lb.push_back(b);
        if (!light_chunk_seen[chui[b]]) {
          light_chunk_seen[chui[b]] = 1;
          ++n_light_chunks;
        }
      }
    if (n_light_chunks >= 2) {
      std::stable_sort(lb.begin(), lb.end(), [&](int64_t a, int64_t b2) {
        return dem_b[a] > dem_b[b2];
      });
      const int64_t nlb = (int64_t)lb.size();
      const int64_t npools = (nlb + kL - 1) / kL;
      // stable sort by pool_of = k % npools == deal round-robin: pool p
      // holds demand-desc positions p, p+npools, ... in that order
      std::vector<int32_t> echunk(nbu), eblk(nbu);
      for (int64_t b = 0; b < nbu; ++b) {
        echunk[b] = (int32_t)chu[b];
        eblk[b] = (int32_t)(gbu[b] & (kL - 1));
      }
      out->virt_rows.assign((size_t)npools * kL, 0);
      std::vector<int64_t> fill(npools, 0);
      for (int64_t k = 0; k < nlb; ++k) {
        const int64_t p = k % npools;
        const int64_t b = lb[k];
        const int64_t idx = fill[p]++;
        echunk[b] = (int32_t)(virt_base + p);
        eblk[b] = (int32_t)idx;
        out->virt_rows[(size_t)p * kL + idx] = (int32_t)gbu[b];
      }
      out->n_virt = npools;
      for (int64_t i = 0; i < m; ++i) {
        chunk[i] = echunk[gbi[i]];
        blkc[i] = eblk[gbi[i]];
      }
    }
  }

  ck.mark("virtual");
  // ---- phase A sort: stable by (chunk, blk, lane) -------------------
  // LSD counting: one fused (blk, lane) 14-bit pass, then chunk
  // (dense-mapped via lookup table when the id range is modest)
  std::vector<int32_t> ord(m), tmp(m);
  for (int64_t i = 0; i < m; ++i) ord[i] = (int32_t)i;
  {
    std::vector<int32_t> bl(m);
    for (int64_t i = 0; i < m; ++i) bl[i] = (blkc[i] << 7) | lane[i];
    std::vector<int64_t> cnt((int64_t)kL * kL + 1, 0);
    for (int64_t i = 0; i < m; ++i) ++cnt[bl[i] + 1];
    for (int64_t b = 0; b < kL * kL; ++b) cnt[b + 1] += cnt[b];
    for (int64_t i = 0; i < m; ++i) tmp[cnt[bl[i]]++] = (int32_t)i;
    ord.swap(tmp);  // identity start: scatter i directly
    // chunk pass: presence bitmap + prefix over the id range (ascending
    // dense map) — replaces the full-entry sort/unique that dominated
    // this stage; ids span [0, virt_base + npools), a few thousand
    int32_t ch_max = 0;
    for (int64_t i = 0; i < m; ++i) ch_max = std::max(ch_max, chunk[i]);
    const int64_t ch_range = (int64_t)ch_max + 1;
    size_t n_chp = 0;
    std::vector<int64_t> ccnt;
    std::vector<int32_t> cidx(m);
    if (ch_range <= (int64_t)1 << 22) {
      std::vector<int32_t> lut(ch_range, -1);
      for (int64_t i = 0; i < m; ++i) lut[chunk[i]] = 1;
      for (int64_t c2 = 0; c2 < ch_range; ++c2)
        if (lut[c2] >= 0) lut[c2] = (int32_t)n_chp++;
      ccnt.assign(n_chp + 1, 0);
      for (int64_t i = 0; i < m; ++i) {
        cidx[i] = lut[chunk[i]];
        ++ccnt[cidx[i] + 1];
      }
    } else {
      std::vector<int32_t> chp(chunk);
      std::sort(chp.begin(), chp.end());
      chp.erase(std::unique(chp.begin(), chp.end()), chp.end());
      n_chp = chp.size();
      ccnt.assign(n_chp + 1, 0);
      for (int64_t i = 0; i < m; ++i) {
        cidx[i] = (int32_t)(std::lower_bound(chp.begin(), chp.end(),
                                             chunk[i]) - chp.begin());
        ++ccnt[cidx[i] + 1];
      }
    }
    for (size_t l = 0; l < n_chp; ++l) ccnt[l + 1] += ccnt[l];
    for (int64_t i = 0; i < m; ++i) tmp[ccnt[cidx[ord[i]]]++] = ord[i];
    ord.swap(tmp);
  }

  ck.mark("sortA");
  // ---- phase A histograms over sorted (chunk, blk) groups -----------
  // cb boundaries in one pass (entries are key-sorted)
  std::vector<int64_t> cb_start;       // entry index of each cb group
  std::vector<int64_t> cb_chunk_v, cb_blk_v;
  std::vector<int32_t> cb_of_entry(m);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = ord[i];
    if (i == 0 || chunk[e] != cb_chunk_v.back() ||
        blkc[e] != cb_blk_v.back()) {
      cb_start.push_back(i);
      cb_chunk_v.push_back(chunk[e]);
      cb_blk_v.push_back(blkc[e]);
    }
    cb_of_entry[i] = (int32_t)(cb_start.size() - 1);
  }
  const int64_t ncb = (int64_t)cb_start.size();
  cb_start.push_back(m);
  std::vector<int64_t> cnt_cbl((size_t)ncb * kL, 0);
  for (int64_t i = 0; i < m; ++i)
    ++cnt_cbl[(size_t)cb_of_entry[i] * kL + lane[ord[i]]];

  ck.mark("histA");
  // ---- per-pool two-shelf packing -----------------------------------
  // pools = maximal runs of equal cb_chunk (ascending == np.unique)
  std::vector<int64_t> pool_cb0;       // first cb of each pool
  for (int64_t cb = 0; cb < ncb; ++cb)
    if (cb == 0 || cb_chunk_v[cb] != cb_chunk_v[cb - 1])
      pool_cb0.push_back(cb);
  const int64_t npools = (int64_t)pool_cb0.size();
  pool_cb0.push_back(ncb);
  std::vector<int64_t> pool_nsub(npools, 0);
  std::vector<std::vector<int64_t>> pool_b0(npools), pool_b1(npools),
      pool_flat(npools);
  std::vector<std::vector<int8_t>> pool_way(npools);
  for (int64_t ci = 0; ci < npools; ++ci) {
    const int64_t c0 = pool_cb0[ci], c1 = pool_cb0[ci + 1];
    const int64_t nb = c1 - c0;
    int64_t dsum = 0, esum = 0;
    for (int64_t b = c0; b < c1; ++b) {
      int64_t d = 0;
      for (int l = 0; l < kL; ++l)
        d = std::max(d, cnt_cbl[(size_t)b * kL + l]);
      dsum += d;
      esum += cb_start[b + 1] - cb_start[b];
    }
    const int64_t cap = dsum + max_push + 1;
    pool_b0[ci].resize(cap);
    pool_b1[ci].resize(cap);
    pool_way[ci].resize(nb);
    pool_flat[ci].resize(esum);
    int64_t ns = 0;
    sell2_twoshelf_pack(&cnt_cbl[(size_t)c0 * kL], nb, max_push, max_holes,
                        hole_tries, pool_b0[ci].data(), pool_b1[ci].data(),
                        pool_way[ci].data(), pool_flat[ci].data(), &ns);
    if (ns < 0) return nullptr;
    pool_nsub[ci] = ns;
  }

  ck.mark("pack");
  // ---- segment layout (longest-first, two-chunks-per-panel rule) ----
  std::vector<int64_t> seg_order(npools);
  for (int64_t i = 0; i < npools; ++i) seg_order[i] = i;
  std::stable_sort(seg_order.begin(), seg_order.end(),
                   [&](int64_t a, int64_t b) {
                     return pool_nsub[a] > pool_nsub[b];
                   });
  std::vector<int64_t> seg_start(npools, 0);
  std::vector<std::vector<int64_t>> panel_touch;
  int64_t q = 0;
  for (int64_t oi = 0; oi < npools; ++oi) {
    const int64_t ci = seg_order[oi];
    if (pool_nsub[ci] == 0) {
      seg_start[ci] = q;
      continue;
    }
    const int64_t p0 = q / kUsable;
    if (p0 < (int64_t)panel_touch.size() && panel_touch[p0].size() >= 2)
      q = (p0 + 1) * kUsable;
    seg_start[ci] = q;
    const int64_t q_end = q + pool_nsub[ci];
    for (int64_t pp = q / kUsable; pp <= (q_end - 1) / kUsable; ++pp) {
      while ((int64_t)panel_touch.size() <= pp)
        panel_touch.push_back({});
      panel_touch[pp].push_back(cb_chunk_v[pool_cb0[ci]]);
    }
    q = q_end;
  }
  const int64_t P = (q + kUsable - 1) / kUsable;
  while ((int64_t)panel_touch.size() < P) panel_touch.push_back({});
  out->P = P;

  ck.mark("segments");
  // ---- per-entry stream slots ---------------------------------------
  std::vector<int64_t> g_abs(m);
  std::vector<int8_t> way_e(m);
  for (int64_t ci = 0; ci < npools; ++ci) {
    const int64_t c0 = pool_cb0[ci], c1 = pool_cb0[ci + 1];
    const int64_t e0p = cb_start[c0], e1p = cb_start[c1];
    const int64_t *flat = pool_flat[ci].data();
    for (int64_t e = e0p; e < e1p; ++e) {
      g_abs[e] = seg_start[ci] + flat[e - e0p];
      way_e[e] = pool_way[ci][cb_of_entry[e] - c0];
    }
  }

  ck.mark("slots");
  // ---- phase B: runs over (panel, row), stable ----------------------
  // order2 = stable sort of phase-A order by key (panel, orow): LSD
  // counting by orow (<= 32768) then panel. Keys are PRECOMPUTED
  // sequentially (orow_A, panel_A indexed by phase-A position) — the
  // double indirection rows_e[ord[ord2[i]]] was the runsB hot spot
  std::vector<int32_t> ord2(m), tmp2(m);
  std::vector<int32_t> orow_A(m), panel_A(m);
  for (int64_t i = 0; i < m; ++i) {
    orow_A[i] = (int32_t)rows_e[ord[i]];
    panel_A[i] = (int32_t)(g_abs[i] / kUsable);
  }
  {
    std::vector<int32_t> rcnt(kSlabRows + 1, 0);
    for (int64_t i = 0; i < m; ++i) ++rcnt[orow_A[i] + 1];
    for (int64_t r = 0; r < kSlabRows; ++r) rcnt[r + 1] += rcnt[r];
    for (int64_t i = 0; i < m; ++i)
      tmp2[rcnt[orow_A[i]]++] = (int32_t)i;   // identity start
    ord2.swap(tmp2);
    std::vector<int32_t> pcnt(P + 1, 0);
    for (int64_t i = 0; i < m; ++i) ++pcnt[panel_A[i] + 1];
    for (int64_t p = 0; p < P; ++p) pcnt[p + 1] += pcnt[p];
    for (int64_t i = 0; i < m; ++i)
      tmp2[pcnt[panel_A[ord2[i]]]++] = ord2[i];
    ord2.swap(tmp2);
  }
  // run boundaries
  std::vector<int64_t> run_start, run_panel, run_row;
  std::vector<int32_t> rid2(m);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = ord2[i];           // index into phase-A order
    const int64_t pan = panel_A[e];
    const int64_t row = orow_A[e];
    if (i == 0 || pan != run_panel.back() || row != run_row.back()) {
      run_start.push_back(i);
      run_panel.push_back(pan);
      run_row.push_back(row);
    }
    rid2[i] = (int32_t)(run_start.size() - 1);
  }
  const int64_t n_runs = (int64_t)run_start.size();
  run_start.push_back(m);
  std::vector<int64_t> run_w(n_runs), run_off(n_runs);
  std::vector<int32_t> run_level(n_runs), run_lane(n_runs), run_out(n_runs);
  int32_t bf_depth = 0;
  for (int64_t r = 0; r < n_runs; ++r) {
    run_w[r] = next_pow2_i(run_start[r + 1] - run_start[r]);
    run_level[r] = level_of_pow2(run_w[r]);
    bf_depth = std::max(bf_depth, run_level[r]);
    run_lane[r] = (int32_t)(run_row[r] & (kL - 1));
    run_out[r] = (int32_t)(run_row[r] >> 7);
  }
  out->bf_depth = bf_depth;  // run_level.max(initial=0) — may be 0
  // order3 = stable sort runs by (panel, lane, -w): LSD counting by
  // (7-level) then lane then panel
  std::vector<int64_t> ord3(n_runs), tmp3(n_runs);
  for (int64_t r = 0; r < n_runs; ++r) ord3[r] = r;
  {
    int64_t wcnt[9] = {0};
    for (int64_t r = 0; r < n_runs; ++r) ++wcnt[(7 - run_level[r]) + 1];
    for (int l = 0; l < 8; ++l) wcnt[l + 1] += wcnt[l];
    for (int64_t r = 0; r < n_runs; ++r)
      tmp3[wcnt[7 - run_level[ord3[r]]]++] = ord3[r];
    ord3.swap(tmp3);
    int64_t lcnt[kL + 1];
    std::fill(lcnt, lcnt + kL + 1, 0);
    for (int64_t r = 0; r < n_runs; ++r) ++lcnt[run_lane[r] + 1];
    for (int l = 0; l < kL; ++l) lcnt[l + 1] += lcnt[l];
    for (int64_t r = 0; r < n_runs; ++r)
      tmp3[lcnt[run_lane[ord3[r]]]++] = ord3[r];
    ord3.swap(tmp3);
    std::vector<int64_t> pcnt(P + 1, 0);
    for (int64_t r = 0; r < n_runs; ++r) ++pcnt[run_panel[r] + 1];
    for (int64_t p = 0; p < P; ++p) pcnt[p + 1] += pcnt[p];
    for (int64_t r = 0; r < n_runs; ++r)
      tmp3[pcnt[run_panel[ord3[r]]]++] = ord3[r];
    ord3.swap(tmp3);
  }
  // grouped exclusive cumsum of run_w within (panel, lane)
  {
    int64_t acc = 0;
    for (int64_t i = 0; i < n_runs; ++i) {
      const int64_t r = ord3[i];
      if (i == 0 || run_panel[r] != run_panel[ord3[i - 1]] ||
          run_lane[r] != run_lane[ord3[i - 1]])
        acc = 0;
      run_off[r] = acc;
      acc += run_w[r];
      if (acc > kAlignBudget) return nullptr;  // align budget breached
    }
  }
  int64_t max_end = 0, max_out = 0;
  for (int64_t r = 0; r < n_runs; ++r) {
    max_end = std::max(max_end, run_off[r] + run_w[r]);
    max_out = std::max(max_out, (int64_t)run_out[r]);
  }
  out->two_tiles = max_end > 126;
  out->has_hi = (max_out >= kL) || (rows_slab > 16384);

  ck.mark("runsB");
  // ---- array fills ---------------------------------------------------
  const int64_t nrows_arr = P * kL;
  const int32_t id_tile = out->two_tiles ? 1 : 0;
  const int32_t defA = 127 | (127 << 7) | (126 << 22) | (id_tile << 29);
  const int32_t defB = (126 << 7) | (id_tile << 14);
  out->wordA.assign((size_t)nrows_arr * kL, defA);
  out->wordB.assign((size_t)nrows_arr * kL, defB);
  out->vals.resize((size_t)nrows_arr * kL * itemsize);
  // zero-fill values with the identity pattern
  if (itemsize == 4) {
    uint32_t z;
    std::memcpy(&z, zero_bytes, 4);
    uint32_t *vp = (uint32_t *)out->vals.data();
    std::fill(vp, vp + (size_t)nrows_arr * kL, z);
  } else if (itemsize == 2) {
    uint16_t z;
    std::memcpy(&z, zero_bytes, 2);
    uint16_t *vp = (uint16_t *)out->vals.data();
    std::fill(vp, vp + (size_t)nrows_arr * kL, z);
  } else if (itemsize == 8) {
    uint64_t z;
    std::memcpy(&z, zero_bytes, 8);
    uint64_t *vp = (uint64_t *)out->vals.data();
    std::fill(vp, vp + (size_t)nrows_arr * kL, z);
  } else {
    for (int64_t i = 0; i < nrows_arr * kL; ++i)
      std::memcpy(&out->vals[(size_t)i * itemsize], zero_bytes, itemsize);
  }
  out->chunk_of_panel.assign((size_t)P * 2, 0);
  for (int64_t pp = 0; pp < P; ++pp) {
    const auto &t = panel_touch[pp];
    if (!t.empty()) {
      out->chunk_of_panel[pp * 2] = (int32_t)t[0];
      out->chunk_of_panel[pp * 2 + 1] = (int32_t)(t.size() > 1 ? t[1] : t[0]);
    }
  }
  // entry scatters (phase-A order): vals + lanesel/way (wordB)
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = ord[i];
    const int64_t pan = g_abs[i] / kUsable, ss = g_abs[i] % kUsable;
    const int64_t rowi = pan * kL + ss;
    std::memcpy(&out->vals[(size_t)(rowi * kL + lane[e]) * itemsize],
                &vals_e[(size_t)e * itemsize], itemsize);
    out->wordB[(size_t)rowi * kL + lane[e]] |=
        col_lane[e] | ((int32_t)way_e[i] << 29);
  }
  // per-sublane blk0/blk1/chunk-select replicated down each panel
  {
    std::vector<int32_t> field((size_t)P * kL, 0);  // per (panel, sublane)
    for (int64_t ci = 0; ci < npools; ++ci) {
      const int64_t ns = pool_nsub[ci];
      if (ns == 0) continue;
      const int64_t c0 = pool_cb0[ci];
      const int64_t pool_chunk = cb_chunk_v[c0];
      for (int64_t s = 0; s < ns; ++s) {
        const int64_t g = seg_start[ci] + s;
        const int64_t sp = g / kUsable, su = g % kUsable;
        const int64_t b0 = pool_b0[ci][s], b1 = pool_b1[ci][s];
        int32_t v0 = b0 >= 0 ? (int32_t)cb_blk_v[c0 + b0] : -1;
        int32_t v1 = b1 >= 0 ? (int32_t)cb_blk_v[c0 + b1] : -1;
        const int32_t blk0 = v0 >= 0 ? v0 : std::max(v1, 0);
        const int32_t blk1 = v1 >= 0 ? v1 : std::max(v0, 0);
        const int32_t csel =
            pool_chunk == out->chunk_of_panel[sp * 2 + 1] ? 1 : 0;
        field[(size_t)sp * kL + su] = (blk0 << 22) | (blk1 << 15) |
                                      (csel << 30);
      }
    }
    for (int64_t pp = 0; pp < P; ++pp)
      for (int64_t u = 0; u < kL; ++u) {
        int32_t *rowp = &out->wordB[(size_t)(pp * kL + u) * kL];
        const int32_t *f = &field[(size_t)pp * kL];
        for (int64_t v = 0; v < kL; ++v) rowp[v] |= f[v];
      }
  }
  // align crossbars per entry (order2): aligned slot j of row-class lane
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = ord2[i];                // phase-A index
    const int64_t r = rid2[i];
    const int64_t j = run_off[r] + (i - run_start[r]);
    const int64_t rowA = run_panel[r] * kL + run_lane[r];
    const int32_t s2 = (int32_t)(g_abs[e] - (int64_t)panel_A[e] * kUsable);
    if (j < kL) {
      int32_t &w = out->wordA[(size_t)rowA * kL + j];
      w = (w & ~(int32_t)127) | s2;
    } else {
      int32_t &w = out->wordA[(size_t)rowA * kL + (j - kL)];
      w = (w & ~(int32_t)(127 << 7)) | (s2 << 7);
    }
  }
  // capture masks + route fields per run; per-panel metadata
  out->p_depth.assign(P, 0);
  out->p_two.assign(P, 0);
  out->p_hi.assign(P, 0);
  std::vector<int64_t> p_end(P, 0);
  for (int64_t r = 0; r < n_runs; ++r) {
    const int64_t rowR = run_panel[r] * kL + run_lane[r];
    const int64_t off = run_off[r];
    if (off < kL)
      out->wordA[(size_t)rowR * kL + off] |= (run_level[r] + 1) << 14;
    else
      out->wordA[(size_t)rowR * kL + (off - kL)] |= (run_level[r] + 1) << 18;
    const int32_t route_lane = (int32_t)(off & (kL - 1));
    const int32_t route_tile = (int32_t)(off >> 7);
    const int64_t o = run_out[r];
    if (o < kL) {
      int32_t &w = out->wordB[(size_t)rowR * kL + o];
      w = (w & ~(int32_t)((127 << 7) | (1 << 14))) | (route_lane << 7) |
          (route_tile << 14);
    } else {
      int32_t &w = out->wordA[(size_t)rowR * kL + (o - kL)];
      w = (w & ~(int32_t)((127 << 22) | (1 << 29))) | (route_lane << 22) |
          (route_tile << 29);
    }
    const int64_t pp = run_panel[r];
    out->p_depth[pp] = std::max(out->p_depth[pp], run_level[r]);
    p_end[pp] = std::max(p_end[pp], off + run_w[r]);
    if (o >= kL) out->p_hi[pp] = 1;
  }
  for (int64_t pp = 0; pp < P; ++pp) out->p_two[pp] = p_end[pp] > 126;

  ck.mark("fills");
  return out.release();
}

void sell2_slab_meta(void *h, int64_t *P, int64_t *n_virt, int32_t *bf_depth,
                     int32_t *two_tiles, int32_t *has_hi) {
  Sell2Slab *s = (Sell2Slab *)h;
  *P = s->P;
  *n_virt = s->n_virt;
  *bf_depth = s->bf_depth;
  *two_tiles = s->two_tiles;
  *has_hi = s->has_hi;
}

// bucket_order != 0: panels are written grouped by call bucket
// (depth-group {0},{1,2},{3+} × two_tiles — the split_calls key), stable
// within a bucket, so the Python side slices CONTIGUOUS per-bucket views
// instead of fancy-select copies. The per-bucket arrays are identical to
// the NumPy path's wa3[sel] selections (stable order preserved).
void sell2_slab_fetch(void *h, int32_t *wordA, int32_t *wordB, uint8_t *vals,
                      int32_t *chunk_of_panel, int32_t *p_depth,
                      uint8_t *p_two, uint8_t *p_hi, int32_t *virt_rows,
                      int32_t bucket_order) {
  Sell2Slab *s = (Sell2Slab *)h;
  const int64_t P = s->P;
  const size_t itemsize = P ? s->vals.size() / ((size_t)P * kL * kL) : 1;
  std::vector<int64_t> perm(P);  // output position per panel
  if (bucket_order) {
    std::vector<int64_t> order(P);
    for (int64_t p = 0; p < P; ++p) order[p] = p;
    auto bkey = [&](int64_t p) {
      const int32_t d = s->p_depth[p];
      const int32_t dg = d == 0 ? 0 : (d <= 2 ? 1 : 2);
      return dg * 2 + (s->p_two[p] ? 1 : 0);
    };
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return bkey(a) < bkey(b); });
    for (int64_t k = 0; k < P; ++k) perm[order[k]] = k;
  } else {
    for (int64_t p = 0; p < P; ++p) perm[p] = p;
  }
  for (int64_t p = 0; p < P; ++p) {
    const int64_t q = perm[p];
    std::memcpy(wordA + (size_t)q * kL * kL,
                s->wordA.data() + (size_t)p * kL * kL, (size_t)kL * kL * 4);
    std::memcpy(wordB + (size_t)q * kL * kL,
                s->wordB.data() + (size_t)p * kL * kL, (size_t)kL * kL * 4);
    std::memcpy(vals + (size_t)q * kL * kL * itemsize,
                s->vals.data() + (size_t)p * kL * kL * itemsize,
                (size_t)kL * kL * itemsize);
    chunk_of_panel[q * 2] = s->chunk_of_panel[p * 2];
    chunk_of_panel[q * 2 + 1] = s->chunk_of_panel[p * 2 + 1];
    p_depth[q] = s->p_depth[p];
    p_two[q] = s->p_two[p];
    p_hi[q] = s->p_hi[p];
  }
  if (s->n_virt)
    std::memcpy(virt_rows, s->virt_rows.data(), s->virt_rows.size() * 4);
}

void sell2_slab_free(void *h) { delete (Sell2Slab *)h; }

}  // extern "C"

// ===================================================================
// sell2 front-end: stable (row, col) sort + adjacent duplicate ⊕-fold —
// the native counterpart of fold_duplicates + sorted_by_row for the
// sell2 build (same FP fold order: stable sort keeps duplicates in
// original index order, np.add.at folds in exactly that order).
// val_kind: 0=f32 1=f64 2=i32 3=i64 4=bool(u8); fold_op: 0=add 1=min
// 2=max 3=or. Returns folded nnz, or -1 on unsupported input.
// ===================================================================

extern "C" int64_t sell2_sort_fold(
    const int32_t *rows, const int32_t *cols, const uint8_t *vals,
    int64_t nnz, int64_t n_rows, int64_t n_cols, int64_t itemsize,
    int32_t val_kind, int32_t fold_op,
    int32_t *out_rows, int32_t *out_cols, uint8_t *out_vals) {
  if (nnz <= 0 || nnz > INT32_MAX) return -1;
  // fast path: already (row, col) sorted (most .mtx files)
  bool sorted = true;
  for (int64_t i = 1; i < nnz; ++i) {
    if (rows[i] < rows[i - 1] ||
        (rows[i] == rows[i - 1] && cols[i] < cols[i - 1])) {
      sorted = false;
      break;
    }
  }
  std::vector<int32_t> ord;
  if (!sorted) {
    ord.resize(nnz);
    std::vector<int32_t> tmp(nnz);
    for (int64_t i = 0; i < nnz; ++i) ord[i] = (int32_t)i;
    constexpr int kDB = 11, kNB = 1 << kDB;
    std::vector<int64_t> cnt(kNB + 1);
    auto n_passes = [](int64_t maxv) {
      int p = 0;
      while ((maxv >> (p * 11)) > 0) ++p;
      return p > 0 ? p : 1;
    };
    auto radix = [&](const int32_t *key, int np_) {
      for (int pass = 0; pass < np_; ++pass) {
        const int sh = pass * kDB;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < nnz; ++i)
          ++cnt[((key[i] >> sh) & (kNB - 1)) + 1];
        for (int b = 0; b < kNB; ++b) cnt[b + 1] += cnt[b];
        for (int64_t i = 0; i < nnz; ++i)
          tmp[cnt[(key[ord[i]] >> sh) & (kNB - 1)]++] = ord[i];
        ord.swap(tmp);
      }
    };
    radix(cols, n_passes(n_cols > 1 ? n_cols - 1 : 0));
    radix(rows, n_passes(n_rows > 1 ? n_rows - 1 : 0));
  }
  auto fold1 = [&](uint8_t *dst, const uint8_t *src) {
    switch (val_kind) {
      case 0: {
        float a, b;
        std::memcpy(&a, dst, 4);
        std::memcpy(&b, src, 4);
        a = fold_op == 0 ? a + b
                         : fold_op == 1 ? std::min(a, b) : std::max(a, b);
        std::memcpy(dst, &a, 4);
        break;
      }
      case 1: {
        double a, b;
        std::memcpy(&a, dst, 8);
        std::memcpy(&b, src, 8);
        a = fold_op == 0 ? a + b
                         : fold_op == 1 ? std::min(a, b) : std::max(a, b);
        std::memcpy(dst, &a, 8);
        break;
      }
      case 2: {
        int32_t a, b;
        std::memcpy(&a, dst, 4);
        std::memcpy(&b, src, 4);
        a = fold_op == 0 ? a + b
                         : fold_op == 1 ? std::min(a, b) : std::max(a, b);
        std::memcpy(dst, &a, 4);
        break;
      }
      case 3: {
        int64_t a, b;
        std::memcpy(&a, dst, 8);
        std::memcpy(&b, src, 8);
        a = fold_op == 0 ? a + b
                         : fold_op == 1 ? std::min(a, b) : std::max(a, b);
        std::memcpy(dst, &a, 8);
        break;
      }
      default:  // bool: ⊕ = or regardless of fold_op (fold_duplicates)
        *dst = *dst || *src;
    }
  };
  int64_t w = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t e = sorted ? i : ord[i];
    const int32_t r = rows[e], c = cols[e];
    if (w >= 0 && out_rows[w] == r && out_cols[w] == c) {
      fold1(&out_vals[(size_t)w * itemsize], &vals[(size_t)e * itemsize]);
    } else {
      ++w;
      out_rows[w] = r;
      out_cols[w] = c;
      std::memcpy(&out_vals[(size_t)w * itemsize],
                  &vals[(size_t)e * itemsize], itemsize);
    }
  }
  return w + 1;
}

#include <malloc.h>

// Keep large allocations in the heap arena instead of per-allocation
// mmap/munmap. On this class of host (virtualized, lazy page backing)
// first-touch faults cost ~50 us/page — a freshly mmapped 40 MB slab
// buffer pays ~2 s before a single byte of real work, and glibc returns
// mmapped chunks to the OS on free, so EVERY encode refaults. With the
// thresholds raised, repeated encodes reuse warm heap pages (measured
// 145x on 140 MB alloc+fill steady state). Process-wide, so callers opt
// in explicitly (native_io._load, SPARSEHARNESS_TPU_MALLOC_TUNE=0 skips).
extern "C" void fastmtx_tune_malloc(void) {
  mallopt(M_MMAP_THRESHOLD, 1 << 30);
  mallopt(M_TRIM_THRESHOLD, 1 << 30);
}

// Heavy-row split + final (rows_k, col) ordering for the sell2 build —
// the native counterpart of build_sell2's closed-form heavy-split (rows
// longer than split_t stripe over ceil(len/split_t) overflow pieces at
// base_pad+, entries dealt rank%p with pieces and in-piece ranks both
// ascending, so the fully sorted order is emitted with zero comparisons).
// Inputs must be (row, col) sorted and duplicate-free (sell2_sort_fold).
// Returns n_pieces (0 = no heavy rows; outputs still filled), or -1.
extern "C" int64_t sell2_heavy_split(
    const int32_t *rows, const int32_t *cols, const uint8_t *vals,
    int64_t nnz, int64_t itemsize, int64_t n_rows, int64_t base_pad,
    int64_t split_t,
    int64_t *k_rows, int64_t *k_cols, uint8_t *k_vals,
    int32_t *piece_owner) {
  if (nnz <= 0) return -1;
  std::vector<int64_t> lens(n_rows, 0);
  for (int64_t i = 0; i < nnz; ++i) ++lens[rows[i]];
  int64_t n_heavy_entries = 0, n_pieces = 0;
  for (int64_t r = 0; r < n_rows; ++r)
    if (lens[r] > split_t) {
      n_heavy_entries += lens[r];
      n_pieces += (lens[r] + split_t - 1) / split_t;
    }
  const int64_t n_light = nnz - n_heavy_entries;
  if (n_pieces == 0) {
    for (int64_t i = 0; i < nnz; ++i) {
      k_rows[i] = rows[i];
      k_cols[i] = cols[i];
    }
    std::memcpy(k_vals, vals, (size_t)nnz * itemsize);
    return 0;
  }
  int64_t w_light = 0, w_heavy = n_light;  // heavy block cursor
  int64_t piece_base = base_pad, pw = 0;
  for (int64_t i = 0; i < nnz;) {
    const int32_t r = rows[i];
    const int64_t len = lens[r];
    if (len <= split_t) {
      k_rows[w_light] = r;
      k_cols[w_light] = cols[i];
      std::memcpy(&k_vals[(size_t)w_light * itemsize],
                  &vals[(size_t)i * itemsize], itemsize);
      ++w_light;
      ++i;
      continue;
    }
    // heavy row: stripe ranks over p pieces; piece j holds q+1 entries
    // for j < rr else q — emit at block + j*q + min(j, rr) + rank/p
    const int64_t p = (len + split_t - 1) / split_t;
    const int64_t q = len / p, rr = len % p;
    for (int64_t rank = 0; rank < len; ++rank) {
      const int64_t j = rank % p;
      const int64_t pos = j * q + (j < rr ? j : rr) + rank / p;
      const int64_t w = w_heavy + pos;
      k_rows[w] = piece_base + j;
      k_cols[w] = cols[i + rank];
      std::memcpy(&k_vals[(size_t)w * itemsize],
                  &vals[(size_t)(i + rank) * itemsize], itemsize);
    }
    for (int64_t j = 0; j < p; ++j) piece_owner[pw++] = r;
    w_heavy += len;
    piece_base += p;
    i += len;
  }
  return n_pieces;
}
