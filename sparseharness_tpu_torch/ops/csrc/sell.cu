// The sell design record's two kernels, for Hopper (sm_90a): a fused
// depth-0 kernel (phase A and the first gather-reduce level in one) and the
// gather-reduce level kernel for the later depths.
//
// Replaces the Pallas TPU kernels of sparseharness_tpu/ops/pallas_sell.py:
// _phase_a_call (kernel :330) with level 0 of _level_call (kernel :361),
// and _level_call at depths 1 and more. On the TPU each is one call per
// slab (and per level): 1 + levels calls per slab, phase A writing the
// slab's contrib stream for level 0 to gather from. Here one fused launch
// covers every slab's level 0 and writes no contrib stream, and one level
// launch per later depth covers every slab that has that level, driven by
// tables that the operand's build derives once from the layouts
// (ops/sell.py:launch_table, fused_groups).
//
// The fused launch, one block per (group of consecutive output rows of a
// level-0 region, 32-lane slice):
//   z[s, j] = mul(x2d[blocksel[r], lanesel[r, j]], vals[r, j]) with r =
//   idx0[s, j] when r < t_a, else 0̄ (the TPU kernel's source padded with
//   0̄); output row q is z[q·w] ⊕ z[q·w + 1] ⊕ ... ⊕ z[q·w + w − 1], folded
//   left to right as the TPU kernel's acc = zr[0::w]; acc = add(acc,
//   zr[t::w]) does.
// A later level, one block per output row and one thread per lane j, does
// the same from the previous level's rows in the work buffer: z[s, j] =
// src[idx[s, j], j]. A non-final level writes its rows into the work
// buffer; a final level writes the slab's rows in canonical order into the
// dp at row0 / 128.
//
// What bounds it: bytes, and where they land. Level 0's gather keeps the
// lane but not the stream row: on a band, a warp's 32 lanes read about 29
// distinct stream rows in one step, so a gather in place touches a 32-byte
// sector of lanesel and one of vals for nearly every 4-byte slot it uses.
// But an output row's slots come from a narrow window of stream rows (on
// the band about 95 rows for 32 lanes), and consecutive output rows' windows
// overlap. So a block takes 512 / w consecutive output rows of 32 lanes
// and stages the products of its window once, with 16-byte loads, in
// shared memory, where the gather is free of bank conflicts (a lane always
// reads its own bank); the stream is then read about once. A block whose
// window is too wide for shared memory (or much wider than its slots)
// gathers in place instead, all its idx loads of a batch first, then the
// stream loads, then x. x2d is at most 2048 × 128 (1 MB f32) and stays in
// L2. The later levels move about 1% of level 0's bytes.
//
// Bit-exactness: each product is rounded to the carrier type on its own
// (__fmul_rn, or a store to shared memory) before any ⊕, so nothing
// contracts into an FMA, and each level ⊕-folds in the TPU kernel's order:
// every semiring, plus_times included, gives the plain torch version's
// bits. No atomics.
//
// Semirings and loads: semiring.cuh.

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kLanes = 128;
constexpr int kEntryWords = 24;  // as ops/sell.py:ENTRY_WORDS
constexpr int kGroupWords = 12;  // as ops/sell.py:GROUP_WORDS
constexpr int kGroupLanes = 32;  // as ops/sell.py:GROUP_LANES
// most stream rows a block may stage: 227 KB of shared memory in 4-byte values
constexpr int kMaxStageRows = 232448 / (kGroupLanes * 4);

// one (slab, level) row of the launch table, as ops/sell.py:launch_table
enum EntryField {
  ROW_BEGIN = 0,  // first output row of the entry within its depth's launch
  D_OUT = 1,      // output rows
  SRC_OFF = 2,    // source: first row in the work buffer (level 0: in the stream)
  SRC_ROWS = 3,   // source rows; idx past them reads 0̄
  IDX_OFF = 4,    // first row of the entry's idx array in the flat idx
  OUT_OFF = 5,    // first output row, in the work buffer or (final) the dp
  FINAL = 6,      // 1: write the dp
  N_REGIONS = 7,
  REGIONS = 8,    // 4 × (w, s0, out row begin, out row end), one per run width
};

// one block of the fused depth-0 launch, as ops/sell.py:fused_groups
enum GroupField {
  G_IDX = 0,       // first idx row of the block's output rows, in the flat idx
  G_W = 1,         // run width
  G_NQ = 2,        // output rows
  G_OUT = 3,       // first output row, in the work buffer or (final) the dp
  G_FINAL = 4,     // 1: write the dp
  G_LANE0 = 5,     // first of the block's kGroupLanes lanes
  G_SRC = 6,       // the slab's first stream row
  G_TA = 7,        // the slab's stream rows; idx at or past them reads 0̄
  G_WIN = 8,       // first staged stream row
  G_WIN_ROWS = 9,  // staged stream rows; 0: the block gathers in place
};

// ⊗ rounded to the carrier type on its own: __fmul_rn is never contracted
// into an FMA with the ⊕ that follows, so plus_times keeps the plain
// version's bits with the product and the fold in one kernel
template <int SR>
__device__ __forceinline__ typename Op<SR>::T product(typename Op<SR>::T x,
                                                      typename Op<SR>::T a) {
  if constexpr (SR == PLUS_TIMES || SR == MAX_TIMES) {
    return __fmul_rn(x, a);
  } else {
    return Op<SR>::mul(x, a);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// One output (q, j): the ⊕ of z[t] for t < w in order, B idx loads in
// flight at a time. Staged: z[t] is the product in shared memory at the
// stream row idx[t] names. In place: the idx loads, then the stream's
// lanesel / vals / blocksel loads, then the x loads, then the fold.
template <int SR, int B, bool STAGED>
__device__ __forceinline__ typename Op<SR>::T fold_run(
    const int* ix, int w, int t_a, const typename Op<SR>::T* stage, int stage_base,
    const typename Op<SR>::T* __restrict__ x2d, const int* __restrict__ lanesel,
    const typename Op<SR>::T* __restrict__ vals, const int* __restrict__ blocksel,
    int64_t src, int j) {
  using O = Op<SR>;
  using T = typename O::T;
  T acc = O::zero();
  for (int t0 = 0; t0 < w; t0 += B) {
    int r[B];
#pragma unroll
    for (int k = 0; k < B; ++k) r[k] = __ldcs(ix + static_cast<int64_t>(t0 + k) * kLanes);
    T z[B];
    if constexpr (STAGED) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        z[k] = r[k] < t_a ? stage[(r[k] + stage_base) * kGroupLanes] : O::zero();
      }
    } else {
      int ls[B], blk[B];
      T v[B];
#pragma unroll
      for (int k = 0; k < B; ++k) {
        if (r[k] < t_a) {
          const int64_t row = src + r[k];
          ls[k] = __ldg(lanesel + row * kLanes + j);
          v[k] = __ldg(vals + row * kLanes + j);
          blk[k] = __ldg(blocksel + row);
        }
      }
#pragma unroll
      for (int k = 0; k < B; ++k) {
        z[k] = r[k] < t_a
                   ? product<SR>(__ldg(x2d + static_cast<int64_t>(blk[k]) * kLanes + ls[k]), v[k])
                   : O::zero();
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) acc = (t0 + k == 0) ? z[k] : O::add(acc, z[k]);
  }
  return acc;
}

// The fused depth-0 launch, one block per GroupField row: nq consecutive
// output rows of one level-0 region, kGroupLanes lanes of them.
//   z[s, j] = idx0[s, j] < t_a ? x2d[blocksel[r], lanesel[r, j]] ⊗ vals[r, j] : 0̄,
//   r = idx0[s, j];  out[q, j] = z[q·w, j] ⊕ z[q·w + 1, j] ⊕ ... ⊕ z[q·w + w − 1, j]
// A staged block first computes the products of its window of stream rows
// (16-byte loads of lanesel and vals, each product once) into shared
// memory, win_rows × kGroupLanes; the fold then gathers from there. Every
// lane reads its own bank whatever the row, so the gather has no bank
// conflicts. Warp i of the block takes output rows i, i + kWarps, ...
template <int SR>
__global__ void __launch_bounds__(kThreads)
sell_fused_kernel(const int* __restrict__ groups, const typename Op<SR>::T* __restrict__ x2d,
                  const int* __restrict__ lanesel, const typename Op<SR>::T* __restrict__ vals,
                  const int* __restrict__ blocksel, const int* __restrict__ idx,
                  typename Op<SR>::T* __restrict__ work, typename Op<SR>::T* __restrict__ dp) {
  using T = typename Op<SR>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  const int* g = groups + static_cast<int64_t>(blockIdx.x) * kGroupWords;
  const int w = __ldg(g + G_W), nq = __ldg(g + G_NQ), lane0 = __ldg(g + G_LANE0);
  const int t_a = __ldg(g + G_TA), win_rows = __ldg(g + G_WIN_ROWS);
  const int64_t src = __ldg(g + G_SRC), win = __ldg(g + G_WIN);
  if (win_rows > 0) {
    constexpr int kQuads = kGroupLanes / 4;
    constexpr int kUnroll = 4;
    const int n = win_rows * kQuads;
    for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
      int4 ls[kUnroll];
      T v[kUnroll][4];
      int blk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) {
          const int64_t row = win + i / kQuads;
          const int64_t off = row * kLanes + lane0 + (i % kQuads) * 4;
          ls[u] = __ldcs(reinterpret_cast<const int4*>(lanesel + off));
          load_strip4(vals + off, v[u]);
          blk[u] = __ldg(blocksel + row);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) {
          const T* xr = x2d + static_cast<int64_t>(blk[u]) * kLanes;
          T p[4];
          p[0] = product<SR>(__ldg(xr + ls[u].x), v[u][0]);
          p[1] = product<SR>(__ldg(xr + ls[u].y), v[u][1]);
          p[2] = product<SR>(__ldg(xr + ls[u].z), v[u][2]);
          p[3] = product<SR>(__ldg(xr + ls[u].w), v[u][3]);
          store4(stage + (i / kQuads) * kGroupLanes + (i % kQuads) * 4, p);
        }
      }
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int j = lane0 + lane;
  const int stage_base = static_cast<int>(src - win);
  T* out = __ldg(g + G_FINAL) ? dp : work;
  const int64_t idx0 = __ldg(g + G_IDX), out0 = __ldg(g + G_OUT);
  for (int q = threadIdx.x >> 5; q < nq; q += kWarps) {
    const int* ix = idx + (idx0 + static_cast<int64_t>(q) * w) * kLanes + j;
    const T* st = stage + lane;
    T acc;
    if (win_rows > 0) {
      acc = w >= 16 ? fold_run<SR, 16, true>(ix, w, t_a, st, stage_base, x2d, lanesel, vals,
                                            blocksel, src, j)
          : w == 4  ? fold_run<SR, 4, true>(ix, w, t_a, st, stage_base, x2d, lanesel, vals,
                                           blocksel, src, j)
                    : fold_run<SR, 1, true>(ix, w, t_a, st, stage_base, x2d, lanesel, vals,
                                           blocksel, src, j);
    } else {
      acc = w >= 16 ? fold_run<SR, 16, false>(ix, w, t_a, st, stage_base, x2d, lanesel, vals,
                                             blocksel, src, j)
          : w == 4  ? fold_run<SR, 4, false>(ix, w, t_a, st, stage_base, x2d, lanesel, vals,
                                            blocksel, src, j)
                    : fold_run<SR, 1, false>(ix, w, t_a, st, stage_base, x2d, lanesel, vals,
                                            blocksel, src, j);
    }
    out[(out0 + q) * kLanes + j] = acc;
  }
}

template <int SR>
__global__ void __launch_bounds__(kLanes)
sell_level_kernel(const int* __restrict__ table, int e0, int n_entries,
             const int* __restrict__ idx, typename Op<SR>::T* work,
             typename Op<SR>::T* __restrict__ dp) {
  using O = Op<SR>;
  using T = typename O::T;
  const int b = blockIdx.x;
  // the entry that owns output row b: the last one whose rows begin at or
  // before it
  int lo = e0, hi = e0 + n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + static_cast<int64_t>(mid) * kEntryWords + ROW_BEGIN) <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int* e = table + static_cast<int64_t>(lo) * kEntryWords;
  const int r = b - __ldg(e + ROW_BEGIN);
  const int n_regions = __ldg(e + N_REGIONS);
  int k = 0;
  while (k + 1 < n_regions && r >= __ldg(e + REGIONS + 4 * k + 3)) ++k;
  const int w = __ldg(e + REGIONS + 4 * k);
  const int s0 = __ldg(e + REGIONS + 4 * k + 1);
  const int q = r - __ldg(e + REGIONS + 4 * k + 2);
  const int j = threadIdx.x;
  const int src_rows = __ldg(e + SRC_ROWS);
  const T* src = work + static_cast<int64_t>(__ldg(e + SRC_OFF)) * kLanes + j;
  const int* ix = idx + (static_cast<int64_t>(__ldg(e + IDX_OFF)) + s0
                         + static_cast<int64_t>(q) * w) * kLanes + j;
  int row = __ldcs(ix);
  T acc = row < src_rows ? src[static_cast<int64_t>(row) * kLanes] : O::zero();
  for (int t = 1; t < w; ++t) {
    row = __ldcs(ix + static_cast<int64_t>(t) * kLanes);
    acc = O::add(acc, row < src_rows ? src[static_cast<int64_t>(row) * kLanes] : O::zero());
  }
  T* out = __ldg(e + FINAL) ? dp : work;
  out[(static_cast<int64_t>(__ldg(e + OUT_OFF)) + r) * kLanes + j] = acc;
}

struct FusedLaunch {
  const int* groups;
  int n_groups, stage_rows;
  const void* x2d;
  const int* lanesel;
  const void* vals;
  const int* blocksel;
  const int* idx;
  void* work;
  void* dp;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    if constexpr (!std::is_same<S, T>::value) {
      return cudaErrorInvalidValue;  // the stream holds the carrier type
    } else {
      const size_t smem = static_cast<size_t>(stage_rows) * kGroupLanes * sizeof(T);
      if (smem > 48 * 1024) {
        const int rc = cudaFuncSetAttribute(sell_fused_kernel<SR>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(smem));
        if (rc != cudaSuccess) return rc;
      }
      sell_fused_kernel<SR><<<static_cast<unsigned>(n_groups), kThreads, smem, stream>>>(
          groups, static_cast<const T*>(x2d), lanesel, static_cast<const T*>(vals), blocksel,
          idx, static_cast<T*>(work), static_cast<T*>(dp));
      return cudaSuccess;
    }
  }
};

struct LevelLaunch {
  const int* table;
  int e0, n_entries, n_rows;
  const int* idx;
  void* work;
  void* dp;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    if constexpr (!std::is_same<S, T>::value) {
      return cudaErrorInvalidValue;
    } else {
      sell_level_kernel<SR><<<static_cast<unsigned>(n_rows), kLanes, 0, stream>>>(
          table, e0, n_entries, idx, static_cast<T*>(work), static_cast<T*>(dp));
      return cudaSuccess;
    }
  }
};

}  // namespace

extern "C" {

// The fused depth-0 launch: n_groups blocks, one per kGroupWords row of the
// int32 groups table. x2d is the padded (xrows, 128) x, lanesel the int32
// (n_sublanes, 128) lanes, vals the (n_sublanes, 128) values and blocksel
// the int32 (n_sublanes,) blocks of every slab's phase-A stream, idx every
// (slab, level) idx array concatenated, work the (rows, 128) work buffer
// of non-final level outputs and dp the (n_pad / 128, 128) result; values
// in the carrier type (float32, or int32 for the int semirings and the
// or_and carrier: strip_dtype says which). stage_rows is the most stream
// rows a block stages (its dynamic shared memory). Launches on `stream`
// and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
int sh_sell_fused(int device, const void* groups, const void* x2d, const void* lanesel,
                  const void* vals, const void* blocksel, const void* idx, void* work,
                  void* dp, int n_groups, int stage_rows, int semiring, int strip_dtype,
                  void* stream) {
  if (n_groups < 0 || stage_rows < 0 || stage_rows > kMaxStageRows) return cudaErrorInvalidValue;
  if (n_groups == 0) return cudaSuccess;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const FusedLaunch launch{static_cast<const int*>(groups), n_groups, stage_rows, x2d,
                           static_cast<const int*>(lanesel), vals,
                           static_cast<const int*>(blocksel), static_cast<const int*>(idx),
                           work, dp, static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// One level depth past 0: entries [e0, e0 + n_entries) of the int32 launch
// table (kEntryWords per entry), n_rows output rows in all, one block each.
// idx is every (slab, level) idx array concatenated, work the (rows, 128)
// work buffer of non-final level outputs, dp the (n_pad / 128, 128)
// result; both in the carrier type. Launches on `stream` and
// returns the launch's cudaError_t; it does not synchronise.
int sh_sell_level(int device, const void* table, const void* idx, void* work, void* dp,
                  int e0, int n_entries, int n_rows, int semiring, int strip_dtype,
                  void* stream) {
  if (e0 < 0 || n_entries <= 0 || n_rows < 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const LevelLaunch launch{static_cast<const int*>(table), e0, n_entries, n_rows,
                           static_cast<const int*>(idx), work, dp,
                           static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
