// The sell design record's two kernels, for Hopper (sm_90a): a fused
// depth-0 kernel (phase A and the first gather-reduce level in one) and the
// level kernel for every later depth.
//
// Replaces the Pallas TPU kernels of sparseharness_tpu/ops/pallas_sell.py:
// _phase_a_call (kernel :330) with level 0 of _level_call (kernel :361),
// and _level_call at depths 1 and more. On the TPU each is one call per
// slab (and per level): 1 + levels calls per slab, phase A writing the
// slab's contrib stream for level 0 to gather from. Here a call is two
// launches whatever the depth: one fused launch covers every slab's level
// 0 and writes no contrib stream, and one level launch covers every later
// depth of every slab, driven by tables that the operand's build derives
// once from the layouts (ops/sell.py:launch_table, fused_groups).
//
// The fused launch, one block per (group of consecutive output rows of a
// level-0 region, 32-lane slice):
//   z[s, j] = mul(x2d[blocksel[r], lanesel[r, j]], vals[r, j]) with r =
//   idx0[s, j] when r < t_a, else 0̄ (the TPU kernel's source padded with
//   0̄); output row q is z[q·w] ⊕ z[q·w + 1] ⊕ ... ⊕ z[q·w + w − 1], folded
//   left to right as the TPU kernel's acc = zr[0::w]; acc = add(acc,
//   zr[t::w]) does.
// The level launch, one block per (slab with a later level, 32-lane
// slice), does the same from the previous level's rows: z[s, j] =
// src[idx[s, j], j], every depth of its slab in turn. Every level keeps
// the lane, so the slice's depths chain inside the block: it copies its
// lanes of the slab's level-0 rows from the work buffer into shared
// memory, the intermediate depths stay there (or, for a slab whose rows
// do not fit, in the work buffer), and the final depth writes the slab's
// rows in canonical order into the dp at row0 / 128. It is launched with
// programmatic dependent launch: its blocks start while the fused launch
// drains and read their table entries and idx rows, which that launch
// does not write, before they wait for it.
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
// L2. The later levels move about 1% of level 0's bytes: what bounds them
// is the time from the fused launch's end to their own, a chain of a few
// dependent steps a depth. One launch keeps the depths' rows on chip and
// starts behind the fused launch's drain, and the copy of the level-0 rows
// spares the L1 a lane-preserving gather from device memory, whose warp
// loads name a different row in nearly every lane.
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
constexpr int kSlices = kLanes / kGroupLanes;
constexpr int kChainWords = 8;  // as ops/sell.py:CHAIN_WORDS
// most stream rows a block may stage: 227 KB of shared memory in 4-byte values
constexpr int kMaxStageRows = 232448 / (kGroupLanes * 4);

// one (slab, level) row of the launch table, as ops/sell.py:launch_table
enum EntryField {
  ROW_BEGIN = 0,  // first output row of the entry within its depth
  D_OUT = 1,      // output rows
  SRC_OFF = 2,    // source: first row in the stream (level 0), the work
                  // buffer (depth 1, or the work path) or the block's
                  // intermediate rows in shared memory (the shared path)
  SRC_ROWS = 3,   // source rows; idx past them reads 0̄
  IDX_OFF = 4,    // first row of the entry's idx array in the flat idx
  OUT_OFF = 5,    // first output row: in the dp (final), else where SRC_OFF
                  // of the next depth points
  FINAL = 6,      // 1: write the dp
  N_REGIONS = 7,
  REGIONS = 8,    // 4 × (w, s0, out row begin, out row end), one per run width
};

// one slab with a later level, a row of the level launch's chain table, as
// ops/sell.py:launch_table
enum ChainField {
  C_LATER = 0,    // levels past 0
  C_SHARED = 1,   // 1: idx, level-0 and intermediate rows in shared memory
  C_ENTRIES = 2,  // the launch-table entry of each later level, depth 1 first
};
constexpr int kMaxLater = kChainWords - C_ENTRIES;
// most rows of kGroupLanes 4-byte words a level block keeps in shared
// memory, beside its kMaxLater table entries: as ops/sell.py:LEVEL_ROWS_MAX
constexpr int kMaxLevelRows = (232448 - 1024) / (kGroupLanes * 4);

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

// The grid dependency of programmatic dependent launch (PDL): the level
// launch may start while the fused launch still runs; wait() returns once
// that launch has completed and its writes are visible. The fused launch
// lets its dependents start as soon as each of its blocks is running. A
// launch without a PDL predecessor (or dependent) passes both straight by.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

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
  launch_dependents();
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

// One output (q, j) of a later level: the ⊕ of z[t] = src[idx[t], j] for
// t < W in order, z[t] = 0̄ where idx[t] ≥ src_rows. ix and src point at
// this lane's first idx slot and source row: in shared memory (SHARED;
// rows kGroupLanes apart) or in device memory (rows kLanes apart; idx
// streamed, the work buffer read through L2, since its rows were written
// by the previous launch or by this block and the read-only cache may hold
// stale lines). B idx loads, then B source loads, are in flight at a time.
template <int SR, int W, bool SHARED>
__device__ __forceinline__ typename Op<SR>::T fold_run(const int* ix,
                                                       const typename Op<SR>::T* src,
                                                       int src_rows) {
  using O = Op<SR>;
  using T = typename O::T;
  constexpr int B = W < 16 ? W : 16;
  constexpr int kStride = SHARED ? kGroupLanes : kLanes;
  T acc = O::zero();
#pragma unroll 1
  for (int t0 = 0; t0 < W; t0 += B) {
    int r[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if constexpr (SHARED) {
        r[k] = ix[(t0 + k) * kStride];
      } else {
        r[k] = __ldcs(ix + static_cast<int64_t>(t0 + k) * kStride);
      }
    }
    T z[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if constexpr (SHARED) {
        z[k] = r[k] < src_rows ? src[r[k] * kStride] : O::zero();
      } else {
        z[k] = r[k] < src_rows ? __ldcg(src + static_cast<int64_t>(r[k]) * kStride)
                               : O::zero();
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) acc = (t0 + k == 0) ? z[k] : O::add(acc, z[k]);
  }
  return acc;
}

template <int SR, bool SHARED>
__device__ __forceinline__ typename Op<SR>::T fold_width(int w, const int* ix,
                                                         const typename Op<SR>::T* src,
                                                         int src_rows) {
  switch (w) {
    case 1: return fold_run<SR, 1, SHARED>(ix, src, src_rows);
    case 4: return fold_run<SR, 4, SHARED>(ix, src, src_rows);
    case 16: return fold_run<SR, 16, SHARED>(ix, src, src_rows);
    default: return fold_run<SR, 64, SHARED>(ix, src, src_rows);
  }
}

// rows of kGroupLanes 4-byte words from device memory (rows kLanes apart,
// from lane lane0) into shared memory, 16 bytes a load, kUnroll loads a
// thread in flight; STREAM: idx, read once; else the work buffer, through L2
template <bool STREAM>
__device__ __forceinline__ void stage_rows(int* dst, const int* src, int rows, int lane0) {
  constexpr int kQuads = kGroupLanes / 4;
  constexpr int kUnroll = 4;
  const int n = rows * kQuads;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int4* p = reinterpret_cast<const int4*>(
            src + static_cast<int64_t>(i / kQuads) * kLanes + lane0 + (i % kQuads) * 4);
        v[u] = STREAM ? __ldcs(p) : __ldcg(p);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) *reinterpret_cast<int4*>(dst + i * 4) = v[u];
    }
  }
}

// The level launch, one block per (ChainField row, kGroupLanes-lane slice):
// every level past 0 of one slab, depth after depth, for 32 lanes. Every
// level keeps the lane, so a lane slice of a slab's output depends only on
// the same lanes of its level-0 rows, and no block waits for another.
//   Before the grid dependency wait, the block reads what the fused launch
//   does not write: its levels' launch-table entries, and (shared path)
//   every later level's idx region rows for its lanes into shared memory,
//   or (work path) a prefetch of those rows into L2.
//   After it, on the shared path, the block copies its slab's level-0 rows
//   (its lanes of them) from the work buffer into shared memory with
//   16-byte loads, so that no gather leaves shared memory: each output of
//   a depth folds its run from there and writes the block's intermediate
//   rows or, at the final depth, the dp at row0 / 128. A lane-preserving
//   gather straight from device memory names a different row in nearly
//   every lane, 32 sectors a warp load; the copy reads each row once, a
//   128-byte line a warp load. On the work path (a slab whose idx, level-0
//   and intermediate rows do not fit) each output gathers and folds its
//   run from device memory, the intermediates going to the work buffer.
//   A block barrier separates the depths.
// Warp i of the block takes output rows i, i + kWarps, ...; every lane of
// a warp is in the same run, so the warp does not diverge. At most 64
// registers a thread, so that four blocks fit an SM: with more (122), the
// band's 344 blocks ran in two waves (scripts/probe_sell_levels_cuda.py).
template <int SR>
__global__ void __launch_bounds__(kThreads, 4)
sell_level_kernel(const int* __restrict__ chains, const int* __restrict__ table,
                  const int* __restrict__ idx, typename Op<SR>::T* work,
                  typename Op<SR>::T* __restrict__ dp) {
  using O = Op<SR>;
  using T = typename O::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int meta[kMaxLater][kEntryWords];
  __shared__ int idx_base[kMaxLater + 1];  // first staged idx row of each later level
  const int* c = chains + static_cast<int64_t>(blockIdx.x / kSlices) * kChainWords;
  const int lane0 = (blockIdx.x % kSlices) * kGroupLanes;
  const int n_later = __ldg(c + C_LATER);
  const bool shared = __ldg(c + C_SHARED) != 0;
  for (int i = threadIdx.x; i < n_later * kEntryWords; i += kThreads) {
    const int64_t e = __ldg(c + C_ENTRIES + i / kEntryWords);
    meta[i / kEntryWords][i % kEntryWords] = __ldg(table + e * kEntryWords + i % kEntryWords);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int base = 0;
    for (int d = 0; d < n_later; ++d) {
      idx_base[d] = base;
      const int* last = meta[d] + REGIONS + 4 * (meta[d][N_REGIONS] - 1);
      base += last[1] + (last[3] - last[2]) * last[0];  // s0 + runs · w of the last region
    }
    idx_base[n_later] = base;
  }
  __syncthreads();
  // shared memory: the idx rows, the level-0 rows, the intermediate rows
  int* slots = reinterpret_cast<int*>(smem);
  T* level0 = reinterpret_cast<T*>(smem) + idx_base[n_later] * kGroupLanes;
  T* inter = level0 + meta[0][SRC_ROWS] * kGroupLanes;
  for (int d = 0; d < n_later; ++d) {
    const int* rows = idx + static_cast<int64_t>(meta[d][IDX_OFF]) * kLanes;
    const int n = idx_base[d + 1] - idx_base[d];
    if (shared) {
      stage_rows<true>(slots + idx_base[d] * kGroupLanes, rows, n, lane0);
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) prefetch_l2(rows + i * kLanes + lane0);
    }
  }
  grid_dependency_wait();
  if (shared) {
    stage_rows<false>(reinterpret_cast<int*>(level0),
                      reinterpret_cast<const int*>(work)
                          + static_cast<int64_t>(meta[0][SRC_OFF]) * kLanes,
                      meta[0][SRC_ROWS], lane0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = lane0 + lane;
  for (int d = 0; d < n_later; ++d) {
    const int* m = meta[d];
    const int d_out = m[D_OUT], src_rows = m[SRC_ROWS], n_regions = m[N_REGIONS];
    const int64_t src_off = m[SRC_OFF], out_off = m[OUT_OFF], idx_off = m[IDX_OFF];
    const bool to_dp = m[FINAL] != 0;
    // the depth's regions in registers; past the last, a first output row
    // that no row reaches
    int rw[4], rs0[4], roc0[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rw[k] = m[REGIONS + 4 * k];
      rs0[k] = m[REGIONS + 4 * k + 1];
      roc0[k] = k < n_regions ? m[REGIONS + 4 * k + 2] : INT_MAX;
    }
    // this lane's idx rows and source rows of the depth in shared memory
    const int* ix_d = slots + idx_base[d] * kGroupLanes + lane;
    const T* src_d = (d == 0 ? level0 : inter + src_off * kGroupLanes) + lane;
    for (int r = threadIdx.x >> 5; r < d_out; r += kWarps) {
      int w = rw[0], s0 = rs0[0], oc0 = roc0[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        if (r >= roc0[k]) {
          w = rw[k];
          s0 = rs0[k];
          oc0 = roc0[k];
        }
      }
      const int run = s0 + (r - oc0) * w;
      const T acc = shared ? fold_width<SR, true>(w, ix_d + run * kGroupLanes, src_d, src_rows)
                           : fold_width<SR, false>(w, idx + (idx_off + run) * kLanes + j,
                                                   work + src_off * kLanes + j, src_rows);
      if (to_dp) {
        dp[(out_off + r) * kLanes + j] = acc;
      } else if (shared) {
        inter[(out_off + r) * kGroupLanes + lane] = acc;
      } else {
        work[(out_off + r) * kLanes + j] = acc;
      }
    }
    if (d + 1 < n_later) __syncthreads();
  }
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
  const int* chains;
  const int* table;
  const int* idx;
  int n_chains, level_rows;
  void* work;
  void* dp;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    if constexpr (!std::is_same<S, T>::value) {
      return cudaErrorInvalidValue;
    } else {
      const size_t smem = static_cast<size_t>(level_rows) * kGroupLanes * sizeof(T);
      if (smem > 48 * 1024) {
        const int rc = cudaFuncSetAttribute(sell_level_kernel<SR>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(smem));
        if (rc != cudaSuccess) return rc;
      }
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(static_cast<unsigned>(n_chains * kSlices));
      config.blockDim = dim3(kThreads);
      config.dynamicSmemBytes = smem;
      config.stream = stream;
      config.attrs = attr;
      config.numAttrs = 1;
      return cudaLaunchKernelEx(&config, sell_level_kernel<SR>, chains, table, idx,
                                static_cast<T*>(work), static_cast<T*>(dp));
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

// The level launch: every level past 0 of every slab, n_chains × 4
// blocks, one per (kChainWords row of the int32 chains table, 32-lane
// slice), after the fused launch on the same stream, which it may overlap
// (programmatic dependent launch). table is the int32 launch table
// (kEntryWords per (slab, level) entry), idx every (slab, level) idx array
// concatenated, work the (rows, 128) work buffer holding the level-0 rows
// (and the work path's intermediates), dp the (n_pad / 128, 128) result;
// both in the carrier type. level_rows is the most rows of 32 4-byte words
// a block keeps in shared memory (its dynamic shared memory). Launches on
// `stream` and returns the launch's cudaError_t; it does not synchronise.
int sh_sell_level(int device, const void* chains, const void* table, const void* idx,
                  void* work, void* dp, int n_chains, int level_rows, int semiring,
                  int strip_dtype, void* stream) {
  if (n_chains < 0 || level_rows < 0 || level_rows > kMaxLevelRows) {
    return cudaErrorInvalidValue;
  }
  if (n_chains == 0) return cudaSuccess;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const LevelLaunch launch{static_cast<const int*>(chains), static_cast<const int*>(table),
                           static_cast<const int*>(idx), n_chains, level_rows, work, dp,
                           static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
