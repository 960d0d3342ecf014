// Semiring SpMM dp over ELL-of-tiles strips, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   sparseharness_tpu/ops/spmm_tiles.py:spmm_bsr_ell (kernel body :130-160).
//
// What it computes, for every padded row R = r·bm + i of the
// (R_blocks, bm, K·bn) strips and every column c < m of X (c_pad, m):
//   dp[R, c] = ⊕_{k < K, l < bn} mul(X[cols[r, k]·bn + l, c], strip[R, k·bn + l])
// for all seven semirings (semiring.cuh); or_and runs on its int32 carrier
// (⊕ = max, ⊗ = min on {0, 1}) and the wrapper takes dp > 0. Each partial
// starts from the true ⊕ identity, as the SpMV strip kernel's do. The
// TPU kernel's K-chunk and slab padding are rules of its grid and are left
// out; the operand's own pad tiles are read as they are. A column beyond
// X's blocks is clamped into range, as the TPU's block index is. No
// atomics: the same call gives the same bits twice.
//
// What bounds it: at m columns the strips (4 or 2 bytes per slot) are read
// once, while every tile pulls its (bn, m) block of X: a block-row reads
// K·bn·m elements of X for bm·K·bn·m operations. At narrow m the strips
// are the large stream and the bound is their bytes (the band at m = 8:
// 100.7 MB of slots, of which the product needs only the 33.3 MB of values
// in the rows' spans, against 2 MB of X); at m = 128 the operations. The
// kernel reads every slot, pads included.
//
// Two thread maps, chosen by m and the shape (sh_spmm_tiles):
//
// - The row map, wherever m is a multiple of 8, bm of 8 and bn of 4 and a
//   group's lanes fit in a block (the band-routed multi-source solves run at
//   m = 8, the blocked ones at 128): a thread takes 8 rows of one block-row
//   and 8 columns, and 8 lanes (m ≤ 8), 4 (m ≤ 64) or 2 (above) split each
//   such group's slots, every 8th, 4th or 2nd 4-slot chunk of a tile to a
//   lane. A lane reads its strip rows straight from device memory, one
//   16-byte (f32, int32) or 8-byte (bf16) streaming load per row and chunk,
//   all 8 issued before their use, and per slot one X row of 8 values
//   through L1 (two 16-byte loads), so that each X value loaded serves 8
//   rows and each strip value 8 columns; the 64 partials stay in registers
//   (at most 128 a thread, two blocks an SM) and the group folds them with
//   xor shuffles, in a fixed order: the same bits twice, min, max and or
//   exact, plus_times in another order than the tile map's. Every thread of
//   a block owns outputs but a block's remainder. On an H100 80GB HBM3 at
//   700 W the band at m = 8 takes 0.043 ms in min_plus against the tile
//   map's 0.17 (scripts/probe_spmm_tiles_cuda.py); at m = 128 the blocked
//   matrix took 0.5050 ms with 2 lanes against the tile map's 1.0550. There
//   every 8-row group reads its tiles' (bn, m) X blocks anew: 2.15 GB a
//   call on the blocked matrix (each X block 32 times), through L2.
// - The tile map, for the shapes the row map refuses (m or bm no multiple
//   of 8, bn of 4, unaligned strips or X, or m / 8 · SPLIT > 256): one block
//   per (block-row, column tile of tn ≤ 128 columns); for each slot the
//   (bm, bn) tile, transposed,
//   and the tile's X rows, up to kXChunk elements at a time, are staged in
//   shared memory by all threads at once, so that the loads of X are
//   coalesced and many are in flight. Each thread then takes one column of
//   the tile and kRows consecutive rows, its partials in registers; a
//   thread's ⊕ runs over the slots in order (k, then l). It keeps all its
//   threads busy only where bm·tn ≥ 4·256: at bm = 8 and m = 8, 16 of 256.
//
// Semirings and bit-exactness: semiring.cuh.

#include <algorithm>

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kRows = 4;        // consecutive tile rows each thread ⊕-accumulates
constexpr int kXChunk = 4096;   // X elements staged at a time: 16 KB
constexpr int kMaxTn = 128;     // columns per block
// The row map's: a thread to kNarrowRows rows of one block-row and kNarrowC
// columns, 8 lanes to each such group up to m = 8, 4 up to m = 64 and 2
// above (scripts/probe_spmm_tiles_cuda.py and scripts/probe_spmm_wide_cuda.py
// timed these against the other maps and splits).
constexpr int kNarrowRows = 8;
constexpr int kNarrowC = 8;

// 8 consecutive values of an X row through the read-only cache, two
// 16-byte loads (aligned)
template <typename T>
__device__ __forceinline__ void load_x8(const T* p, T (&v)[8]) {
#pragma unroll
  for (int h = 0; h < 8; h += 4) {
    T q[4];
    load_x4<false>(p + h, q);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[h + j] = q[j];
  }
}

// One block per (block-row r, column tile ct of tn columns), ct fastest so
// that the column tiles of a block-row read its strip from L2. Thread t takes
// column t % tn of the tile and rows i0 + 4·g .. i0 + 4·g + 3 (g = t / tn) of
// each pass of 4·(256 / tn) rows. The tile is held transposed, (bn, bm4) with
// bm4 = bm rounded up to 4, so a thread's four rows are one 16-byte load.
template <int SR, typename S>
__global__ void __launch_bounds__(kThreads)
spmm_tiles_kernel(const S* __restrict__ strips, const int* __restrict__ cols,
                  const typename Op<SR>::T* __restrict__ x,
                  typename Op<SR>::T* __restrict__ out, int bm, int bm4, int kbn, int bn,
                  int k, int m, int tn_log2, int n_ct, int c_blocks) {
  using O = Op<SR>;
  using T = typename O::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // (bn, bm4): the current slot, transposed
  T* xs = tile + bn * bm4;               // (chunk rows, tn): X rows of the slot

  const int tn = 1 << tn_log2;
  const int64_t r = blockIdx.x / n_ct;
  const int col0 = (blockIdx.x % n_ct) * tn;
  const int lane_c = threadIdx.x & (tn - 1);
  const int g = threadIdx.x >> tn_log2;
  const int rows_per_pass = (kThreads >> tn_log2) * kRows;
  const int chunk = min(bn, kXChunk >> tn_log2);  // X rows staged at a time
  const int col = col0 + lane_c;
  const bool active = col < m;
  const S* srow = strips + r * bm * kbn;

  for (int i0 = 0; i0 < bm; i0 += rows_per_pass) {
    const int row = i0 + g * kRows;  // this thread's first row
    const bool rows_live = active && row < bm;
    T acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = O::identity();
    for (int kk = 0; kk < k; ++kk) {
      // a column beyond X's blocks is clamped into range, as the TPU's
      // block index is
      const int xb = min(max(__ldg(cols + r * k + kk), 0), c_blocks - 1);
      const T* xblock = x + static_cast<int64_t>(xb) * bn * m;
      for (int l0 = 0; l0 < bn; l0 += chunk) {
        const int rows = min(chunk, bn - l0);
        __syncthreads();  // the previous chunk (and tile) is consumed
        if (l0 == 0) {
#pragma unroll 4
          for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
            const int i = e / bn;
            const int l = e - i * bn;
            tile[l * bm4 + i] = load_strip1(srow + static_cast<int64_t>(i) * kbn + kk * bn + l);
          }
        }
#pragma unroll 4
        for (int e = threadIdx.x; e < rows << tn_log2; e += kThreads) {
          const int c = col0 + (e & (tn - 1));
          xs[e] = c < m ? __ldg(xblock + static_cast<int64_t>(l0 + (e >> tn_log2)) * m + c)
                        : O::identity();
        }
        __syncthreads();
        if (rows_live) {
#pragma unroll 4
          for (int l = 0; l < rows; ++l) {
            const T xv = xs[(l << tn_log2) + lane_c];
            T a[kRows];
            load_x4<true>(tile + (l0 + l) * bm4 + row, a);
#pragma unroll
            for (int q = 0; q < kRows; ++q) acc[q] = O::add(acc[q], O::mul(xv, a[q]));
          }
        }
      }
    }
    if (rows_live) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (row + q < bm) out[(r * bm + row + q) * m + col] = acc[q];
    }
  }
}

// The row map. A group of SPLIT adjacent lanes takes kNarrowRows = 8
// consecutive rows of one block-row (bm a multiple of 8) and kNarrowC = 8
// consecutive columns: thread t of block b is lane s = t % SPLIT of group
// t / group_threads of the block, rows 8·(b·groups_per_block + t /
// group_threads) on, columns from 8·((t % group_threads) / SPLIT), with
// group_threads = m / 8 · SPLIT. Per tile k the lane walks its 4-slot chunks
// (s, s + SPLIT, ...): the chunk of its 8 strip rows loaded before any is
// used, then per slot one X row of 8 values, ⊗-ed with 8 strip values, so
// that each X value loaded serves 8 rows and each strip value 8 columns. The
// SPLIT lanes, aligned in their warp, then fold their partials with xor
// shuffles.
template <int SR, typename S, int SPLIT>
__global__ void __launch_bounds__(kThreads, 2)
spmm_rows_kernel(const S* __restrict__ strips, const int* __restrict__ cols,
                 const typename Op<SR>::T* __restrict__ x,
                 typename Op<SR>::T* __restrict__ out, int64_t n_rows, int bm, int kbn,
                 int bn, int k, int m, int group_threads, int groups_per_block,
                 int c_blocks) {
  using O = Op<SR>;
  using T = typename O::T;
  constexpr int RT = kNarrowRows;
  constexpr int C = kNarrowC;
  const int local = threadIdx.x / group_threads;
  const int within = threadIdx.x - local * group_threads;
  const int s = within % SPLIT;
  const int col = within / SPLIT * C;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * groups_per_block + local) * RT;
  const bool live = local < groups_per_block && row0 < n_rows;
  T acc[RT][C];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = O::identity();
  if (live) {
    const int64_t r = row0 / bm;
    const S* srow = strips + row0 * kbn;
    const int n_chunks = bn / 4;
    for (int kk = 0; kk < k; ++kk) {
      const int xb = min(max(__ldg(cols + r * k + kk), 0), c_blocks - 1);
      const T* xt = x + static_cast<int64_t>(xb) * bn * m + col;
      const S* st = srow + kk * bn;
      for (int q = s; q < n_chunks; q += SPLIT) {
        T a[RT][4];
#pragma unroll
        for (int i = 0; i < RT; ++i) load_strip4(st + static_cast<int64_t>(i) * kbn + q * 4, a[i]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          T xv[C];
          load_x8(xt + static_cast<int64_t>(q * 4 + w) * m, xv);
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < C; ++j) acc[i][j] = O::add(acc[i][j], O::mul(xv[j], a[i][w]));
        }
      }
    }
  }
#pragma unroll
  for (int d = 1; d < SPLIT; d <<= 1) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j)
        acc[i][j] = O::add(acc[i][j], __shfl_xor_sync(0xffffffffu, acc[i][j], d));
  }
  if (live && s == 0) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) out[(row0 + i) * m + col + j] = acc[i][j];
  }
}

// What both maps are given: the C interface's arguments.
struct Args {
  const void* strips;
  const int* cols;
  const void* x;
  void* out;
  int64_t r_blocks;
  int bm, kbn, k, m, c_blocks;
  cudaStream_t stream;
};

struct TilesLaunch {
  Args a;
  int tn_log2;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const int bn = a.kbn / a.k;
    const int tn = 1 << tn_log2;
    const int n_ct = (a.m + tn - 1) / tn;
    const int bm4 = (a.bm + kRows - 1) / kRows * kRows;
    const int chunk = std::min(bn, kXChunk / tn);
    const size_t smem = (static_cast<size_t>(bn) * bm4 + static_cast<size_t>(chunk) * tn) *
                        sizeof(T);
    if (smem > 48 * 1024) {
      const int rc = cudaFuncSetAttribute(spmm_tiles_kernel<SR, S>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
    }
    spmm_tiles_kernel<SR, S><<<static_cast<unsigned>(a.r_blocks * n_ct), kThreads, smem,
                               a.stream>>>(
        static_cast<const S*>(a.strips), a.cols, static_cast<const T*>(a.x),
        static_cast<T*>(a.out), a.bm, bm4, a.kbn, bn, a.k, a.m, tn_log2, n_ct, a.c_blocks);
    return cudaSuccess;
  }
};

// The tile map: tn is m rounded up to a power of two, at most kMaxTn.
inline int tiles_launch(const Args& a, TilesLaunch* launch) {
  int tn_log2 = 0;
  while ((1 << tn_log2) < std::min(a.m, kMaxTn)) ++tn_log2;
  if (a.r_blocks * ((a.m + (1 << tn_log2) - 1) >> tn_log2) > INT_MAX)
    return cudaErrorInvalidValue;
  *launch = TilesLaunch{a, tn_log2};
  return cudaSuccess;
}

template <int SPLIT>
struct RowsLaunch {
  Args a;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const int group_threads = a.m / kNarrowC * SPLIT;
    const int groups_per_block = kThreads / group_threads;
    const int64_t n_groups = a.r_blocks * a.bm / kNarrowRows;
    spmm_rows_kernel<SR, S, SPLIT>
        <<<static_cast<unsigned>((n_groups + groups_per_block - 1) / groups_per_block),
           kThreads, 0, a.stream>>>(
            static_cast<const S*>(a.strips), a.cols, static_cast<const T*>(a.x),
            static_cast<T*>(a.out), a.r_blocks * a.bm, a.bm, a.kbn, a.kbn / a.k, a.k, a.m,
            group_threads, groups_per_block, a.c_blocks);
    return cudaSuccess;
  }
};

// The row map with SPLIT lanes a group, or cudaErrorInvalidValue for a
// shape it does not take: bm and m multiples of 8; bn a multiple of 4 and
// the strips aligned for their 4-slot loads; X 16-byte aligned; a group
// within a block.
template <int SPLIT>
int rows_launch(const Args& a, int strip_dtype, RowsLaunch<SPLIT>* launch) {
  const int group_threads = a.m / kNarrowC * SPLIT;
  const uintptr_t align = strip_dtype == STRIP_BF16 ? 8 : 16;
  if (a.bm % kNarrowRows != 0 || a.m % kNarrowC != 0 || (a.kbn / a.k) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a.strips) % align != 0 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 != 0 || group_threads > kThreads)
    return cudaErrorInvalidValue;
  const int groups_per_block = kThreads / group_threads;
  if ((a.r_blocks * a.bm / kNarrowRows + groups_per_block - 1) / groups_per_block > INT_MAX)
    return cudaErrorInvalidValue;
  *launch = RowsLaunch<SPLIT>{a};
  return cudaSuccess;
}

// Launches the row map with SPLIT lanes a group into *rc, or returns false
// for a shape it does not take.
template <int SPLIT>
bool run_rows(const Args& a, int semiring, int strip_dtype, int* rc) {
  RowsLaunch<SPLIT> launch;
  if (rows_launch(a, strip_dtype, &launch) != cudaSuccess) return false;
  *rc = dispatch(semiring, strip_dtype, launch);
  return true;
}

// Checks the C interface's arguments; sets *done when there is nothing to do.
inline int check_args(const Args& a, bool* done) {
  *done = false;
  if (a.bm <= 0 || a.k <= 0 || a.kbn % a.k != 0 || a.r_blocks < 0 || a.m < 0 ||
      a.c_blocks <= 0)
    return cudaErrorInvalidValue;
  if (static_cast<size_t>(a.bm) * (a.kbn / a.k) * 4 > 48 * 1024) return cudaErrorInvalidValue;
  *done = a.r_blocks == 0 || a.m == 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dp over the padded rows: out (r_blocks·bm, m), row-major, in the carrier
// type (float32, or int32 for the int semirings and the or_and carrier). x is
// X padded to (c_blocks·bn, m), row-major, in the same type; cols the int32
// (r_blocks, K) block-columns. The row map takes every shape it can
// (rows_launch), the tile map the rest. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
int sh_spmm_tiles(int device, const void* strips, const void* cols, const void* x,
                  void* out, long long r_blocks, int bm, int kbn, int k, int m,
                  int c_blocks, int semiring, int strip_dtype, void* stream) {
  const Args a{strips, static_cast<const int*>(cols), x, out, r_blocks, bm, kbn, k, m,
               c_blocks, static_cast<cudaStream_t>(stream)};
  bool done;
  int rc = check_args(a, &done);
  if (rc != cudaSuccess || done) return rc;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const bool rows = m <= 8    ? run_rows<8>(a, semiring, strip_dtype, &rc)
                    : m <= 64 ? run_rows<4>(a, semiring, strip_dtype, &rc)
                              : run_rows<2>(a, semiring, strip_dtype, &rc);
  if (!rows) {
    TilesLaunch tiles;
    rc = tiles_launch(a, &tiles);
    if (rc == cudaSuccess) rc = dispatch(semiring, strip_dtype, tiles);
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
