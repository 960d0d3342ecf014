// Ragged (sell2) semiring SpMV dp over (128, 128) panels, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel sparseharness_tpu/ops/pallas_sell2.py:
// _panel_call (kernel body at :926), one pallas_call per (slab, bucket)
// layout. On the TPU every step is a (128, 128) crossbar: x staging by
// chunk, ⊗, an align crossbar, an XOR butterfly with capture masks, route
// crossbars, and ⊕ into the slab's out tile across a sequential grid. Here
// the crossbars become plain indexing, driven by a plan that
// sparseharness_tpu_torch/ops/sell2.py:make_plan decodes once per operand,
// on the device, from wordA and wordB.
//
// What it computes. Stream slot (s, l) of global panel g, with
// b = wordB[g·128 + s, l]:
//   x  = x[xbase[g, s, way] + (b & 127)], way = (b >> 29) & 1
//        (0̄ past the end of x, as the TPU's zero-padded x; xbase is the
//        first column of the x block that sublane s binds for that way,
//        through its chunk or virtual chunk, decoded from wordB's row 0)
//   contrib[s, l] = x ⊗ vals[g·128 + s, l]
// A run (row-class l, level v) is the ⊕ of contrib[a(j), l] over its 2^v
// aligned slots j, a(j) the align sublane of wordA, taken in the
// butterfly's pairwise order. Padding slots name sublane 127, whose values
// are 0̄, so their products enter every run exactly as on the TPU. Each dp
// row then ⊕-accumulates its runs: 0̄ ⊕ the runs of one layout, in panel
// order, and these per-layout partials ⊕-combined in layout order, as the
// TPU's out tiles are. Overflow pieces of split rows (dp rows past
// base_pad) fold into their owner row last: the identity ⊕ each piece, one
// after another.
//
// The design. Two launches a call; the second is a programmatic dependent
// launch, so it starts while the first runs and loads its plan tables
// before it waits for the first's run values.
// (1) Panel stage: a run of row-class l reads only column l of its panel's
//     products, so a block owns one (panel, 32-lane group): 4,096 products,
//     16 KB of shared memory, several blocks resident on an SM. Each thread
//     loads its 16 stream slots as four 16-byte rows of wordB and of vals,
//     all before it uses any, then gathers x. The plan lists each group's
//     runs in slots of 128, widest first, so every run lies aligned inside
//     one chunk of 128 slots; a warp reduces a chunk at once, 4 slots a
//     lane: two pairwise ⊕ in registers, then __shfl_xor_sync with lane
//     masks 1, 2, 4, 8 and 16, which pairs slot i with slot i ^ 2^k at step
//     k: the butterfly's pairwise order. The lane that holds a run's first
//     slot writes the run's value at the run's id. A group with more than
//     BLOCK_CHUNK_CAP chunks is cut over several blocks, so no block
//     carries several times the median, and a panel's blocks are launched
//     together, panels with the most chunks first, so that the four groups
//     read each stream row at about the same time.
// (2) Row stage: one warp per overflow piece row loads its runs (at most
//     256, 8 a lane) at once and one lane folds them in order from shared
//     memory, so the pieces of a hub row spread over the card. That lane's
//     fold issues its instructions alone, so it takes eight values in two
//     16-byte loads and folds eight with no layout opening among them (the
//     most) in eight adds. The block that finishes an owner's last piece (a
//     count per owner, which only says who folds) stages the owner's piece
//     values with all its threads, and one thread folds them in order and
//     writes the row. One thread per other output row reduces its runs,
//     loading them in batches. The dp of the old design (a row launch and
//     a fold launch) is never written.
// Every ⊕ has a fixed order, so every semiring, plus_times included, gives
// the plain torch version's bits on every run.
//
// What bounds it. The least traffic is bytes: the stream, x and the
// output once, 0.0135 ms at the ragged bench shape. The panel stage reads
// wordB and vals once (8 B a slot in f32, 6 in bf16), the plan's slot
// words (2 B a run slot) and x through L2, and writes one value a run,
// coalesced; wordA and chunk are read by the plan once, not by a call. The
// four lane groups of a panel gather the same x blocks again, so x moves
// through L2 several times. The row stage reads the row pointers and the
// row-sorted run ids in order, but each run value with a load of its own:
// a row's runs lie in as many panels, so each 4-byte value costs a 32-byte
// sector, and the count of such loads, one a run, bounds the stage. On the
// Graph500 Kronecker graph at scale 20 (25.2 M runs, 17.3 M of them in
// 87,020 pieces of 21,700 hub rows) that is 6–7 ps a run over the card
// beyond reading the values in order. Writing each run value at its place
// in row order instead, so that the row stage reads a row's values in one
// stretch, scatters the same count of 4-byte stores from the panel stage,
// which L2 does not merge: 12–14 ps a run, a loss of about 300 µs a call
// there (PERF.md §6 has the probe runs). The operations, one ⊗ a slot and
// about one ⊕ a run slot, are far below the card's. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W in f32 plus_times
// (chip_smoke.py, scripts/probe_sell2_stages_cuda.py): at
// power_law_coo(500000, 2000000, alpha=1.5, seed=13), 0.033–0.035 ms a
// call, the panel stage 0.0165 and the row stage 0.0196–0.0227 (0.0230
// before the lean fold), where one thread's fold of a 1,043-piece owner
// sets the row stage; the previous design, a panel, a row and a fold
// kernel, took 0.094–0.103 ms. At the Kronecker graph, the panel stage
// 0.290 ms and the row stage 0.291 (its pieces alone 0.213–0.218, its
// plain rows alone 0.096–0.099; 0.375 before the lean fold).
// PERF.md §6 #7 has the full record.
//
// Semirings, loads and bit-exactness: semiring.cuh.

#include "semiring.cuh"

// The launch as ops/sell2.py:_Launch holds it, made once per operand.
struct Sell2Plan {
  const long long* panel_ptrs;      // (G, 2): wordB and vals of each panel
  const int* xbase;                 // (G, 128, 2)
  const int4* blocks;               // (B,): panel, lane group, chunks [z, w)
  const unsigned short* slot_word;  // (C·128,): product index | (level + 1) << 12
  const int* chunk_run0;            // (C + 1,): runs before each chunk
  const int* row_ptr;               // (n_out + 1,)
  const int* row_runs;              // (R,)
  const int* owners;                // (O, 3): owner row, pieces [k0, k1)
  const int* piece_slot;            // (n_pieces,): each piece's owner in owners
  const unsigned* owner_bits;       // (ceil(n_final / 32),)
  int* owner_done;                  // (O,): pieces done this call, 0 between calls
  int n_blocks, n_runs, n_pieces, n_final, base_pad, val_dtype, device;
};

namespace {

using namespace sh;

constexpr int kLanes = 128;
constexpr int kGroupLanes = 32;                     // lanes a panel block owns
constexpr int kGroupSlots = kLanes * kGroupLanes;   // its products
constexpr int kPanelThreads = 256;
constexpr int kPanelWarps = kPanelThreads / 32;
// four panel blocks an SM (at most 64 registers a thread): 0.290 against
// 0.303 ms a panel stage at the Kronecker shape where ptxas chose freely
// (56 registers, the same four blocks), and five spill
constexpr int kPanelMinBlocks = 4;
constexpr int kBlockChunkCap = 32;                  // as ops/sell2.py:BLOCK_CHUNK_CAP
constexpr int kChunksPerWarp = kBlockChunkCap / kPanelWarps;
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowBatch = 8;                        // run loads in flight a row
constexpr int kWarpRounds = 8;                      // run loads in flight a lane
constexpr int kWarpRuns = 32 * kWarpRounds;         // 256: a dp row's most
constexpr int kRowStage = kRowWarps * kWarpRuns;    // piece values staged at once
constexpr int kIdMask = 0x7fffffff;                 // row_runs: run id; bit 31 opens a layout

// Programmatic dependent launch (sm_90): the row stage is launched to start
// while the panel stage runs, and waits here, after loading its plan
// tables, until the panel stage's run values are written and visible.
// Every thread of the row stage passes here, so it never ends first. The
// row stage's run_vals pointer is not __restrict__: through a read-only
// restrict pointer the compiler may issue a load of run values whose
// address it already has above the wait.
__device__ __forceinline__ void wait_for_panel_stage() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

template <int SR, typename S>
__global__ void __launch_bounds__(kPanelThreads, kPanelMinBlocks)
sell2_panel_kernel(const Sell2Plan plan, const typename Op<SR>::T* __restrict__ x,
                   long long n_x, typename Op<SR>::T* __restrict__ run_vals) {
  using O = Op<SR>;
  using T = typename O::T;
  __shared__ __align__(16) T prod[kGroupSlots];  // [a·32 + l − 32q]
  __shared__ int xbase[kLanes * 2];

  asm volatile("griddepcontrol.launch_dependents;");  // the row stage may start
  const int4 blk = __ldg(plan.blocks + blockIdx.x);
  const int g = blk.x, q = blk.y, c0 = blk.z, c1 = blk.w;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the warp's chunks: 4 slot words a lane, and each chunk's first run id
  uint2 words[kChunksPerWarp];
  int run0[kChunksPerWarp];
#pragma unroll
  for (int i = 0; i < kChunksPerWarp; ++i) {
    const int c = c0 + warp + i * kPanelWarps;
    words[i] = c < c1 ? __ldg(reinterpret_cast<const uint2*>(plan.slot_word) +
                              static_cast<long long>(c) * 32 + lane)
                      : make_uint2(0, 0);
    run0[i] = c < c1 ? __ldg(plan.chunk_run0 + c) : 0;
  }

  // this thread's 16 slots: sublanes (tid >> 3) + 32 i, lanes 32q + 4 (tid & 7) + 0..3
  const int* wb = reinterpret_cast<const int*>(__ldg(plan.panel_ptrs + 2 * g));
  const S* vals = reinterpret_cast<const S*>(__ldg(plan.panel_ptrs + 2 * g + 1));
  const int col = q * kGroupLanes + 4 * (tid & 7);
  const int s0 = tid >> 3;
  int b[4][4];
  T v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = (s0 + 32 * i) * kLanes + col;
    const int4 t = __ldcs(reinterpret_cast<const int4*>(wb + off));
    b[i][0] = t.x; b[i][1] = t.y; b[i][2] = t.z; b[i][3] = t.w;
    load_strip4(vals + off, v[i]);
  }
  xbase[tid] = __ldg(plan.xbase + static_cast<long long>(g) * 2 * kLanes + tid);
  __syncthreads();

  T xv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int* base = xbase + 2 * (s0 + 32 * i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long xi = static_cast<long long>(base[(b[i][k] >> 29) & 1]) + (b[i][k] & 127);
      xv[i][k] = xi < n_x ? __ldg(x + xi) : O::zero();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = O::mul(xv[i][k], v[i][k]);
    store4(prod + (s0 + 32 * i) * kGroupLanes + 4 * (tid & 7), r);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kChunksPerWarp; ++i) {
    if (c0 + warp + i * kPanelWarps >= c1) break;  // warp-uniform
    const unsigned w[4] = {words[i].x & 0xffffu, words[i].x >> 16, words[i].y & 0xffffu,
                           words[i].y >> 16};
    T t[4], cap[4];
    int lv[4];  // level + 1 where a run starts, else 0
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t[k] = prod[w[k] & 0xfff];
      lv[k] = static_cast<int>(w[k] >> 12);
      cap[k] = t[k];
    }
    const T s01 = O::add(t[0], t[1]), s23 = O::add(t[2], t[3]);
    if (lv[0] == 2) cap[0] = s01;
    if (lv[2] == 2) cap[2] = s23;
    T s = O::add(s01, s23);
    if (lv[0] == 3) cap[0] = s;
    const int top = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(lv[0])));
#pragma unroll
    for (int m = 1, level = 4; m < 32; m <<= 1, ++level) {
      if (level > top) break;  // warp-uniform
      s = O::add(s, __shfl_xor_sync(0xffffffffu, s, m));
      if (lv[0] == level) cap[0] = s;
    }
    // run ids in slot order: the chunk's first id plus the starts before
    const int n = (lv[0] != 0) + (lv[1] != 0) + (lv[2] != 0) + (lv[3] != 0);
    int incl = n;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, m);
      if (lane >= m) incl += up;
    }
    int id = run0[i] + incl - n;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lv[k]) run_vals[id++] = cap[k];
    }
  }
}

// 0̄ ⊕ (per-layout partials of dp row `row`'s runs, in order), as the TPU's
// out tiles accumulate them; one thread, kRowBatch run loads in flight
template <int SR>
__device__ __forceinline__ typename Op<SR>::T row_value(
    const Sell2Plan& plan, const typename Op<SR>::T* run_vals, int row) {
  using O = Op<SR>;
  using T = typename O::T;
  const int k0 = __ldg(plan.row_ptr + row), k1 = __ldg(plan.row_ptr + row + 1);
  T total = O::zero(), part = O::zero();
  for (int k = k0; k < k1; k += kRowBatch) {
    int e[kRowBatch];
    T v[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) e[j] = k + j < k1 ? __ldg(plan.row_runs + k + j) : 0;
    wait_for_panel_stage();
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) v[j] = k + j < k1 ? run_vals[e[j] & kIdMask] : O::zero();
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (k + j < k1) {
        if (e[j] < 0) {  // the first run of the next layout
          total = O::add(total, part);
          part = O::zero();
        }
        part = O::add(part, v[j]);
      }
    }
  }
  wait_for_panel_stage();  // also where the row has no run
  return k0 < k1 ? O::add(total, part) : total;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const int* p, int (&v)[4]) {
  const int4 t = *reinterpret_cast<const int4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// In order from 16-byte aligned shared memory, by one lane: part ⊕= v[j],
// first closing the layout's partial into total where bit j of `opens` is
// set. One lane folding is bound by the instructions it issues, so eight
// values come in two 16-byte loads, and eight with no bit set (most: a
// layout opens a few times a row) fold in eight adds, with no test a value.
template <int SR>
__device__ __forceinline__ void fold_runs(const typename Op<SR>::T* v, const unsigned* opens,
                                          int n, typename Op<SR>::T& total,
                                          typename Op<SR>::T& part) {
  using O = Op<SR>;
  using T = typename O::T;
  for (int j0 = 0; j0 < n; j0 += 8) {
    T t[2][4];
    load4(v + j0, t[0]);
    load4(v + j0 + 4, t[1]);
    const unsigned bits = (opens[j0 >> 5] >> (j0 & 31)) & 0xffu;
    if (bits == 0 && j0 + 8 <= n) {
#pragma unroll
      for (int i = 0; i < 8; ++i) part = O::add(part, t[i >> 2][i & 3]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (j0 + i < n) {
        if ((bits >> i) & 1u) {
          total = O::add(total, part);
          part = O::zero();
        }
        part = O::add(part, t[i >> 2][i & 3]);
      }
    }
  }
}

// acc ⊕ v[0] ⊕ ... ⊕ v[n − 1] in order, by one thread, from 16-byte aligned
// shared memory, 16 values loaded at a time
template <int SR>
__device__ __forceinline__ typename Op<SR>::T fold_values(const typename Op<SR>::T* v, int n,
                                                          typename Op<SR>::T acc) {
  using T = typename Op<SR>::T;
  int j0 = 0;
  for (; j0 + 16 <= n; j0 += 16) {
    T t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(v + j0 + 4 * i, t[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = Op<SR>::add(acc, t[i][k]);
  }
  for (; j0 < n; ++j0) acc = Op<SR>::add(acc, v[j0]);
  return acc;
}

// row_value by a warp: up to kWarpRuns runs loaded at once, kWarpRounds a
// lane, staged in the warp's shared buffer and folded in order by lane 0;
// every lane gets the value
template <int SR>
__device__ __forceinline__ typename Op<SR>::T warp_row_value(
    const Sell2Plan& plan, const typename Op<SR>::T* run_vals, int row,
    int lane, typename Op<SR>::T* sv, unsigned* so) {
  using O = Op<SR>;
  using T = typename O::T;
  const int k0 = __ldg(plan.row_ptr + row), k1 = __ldg(plan.row_ptr + row + 1);
  T total = O::zero(), part = O::zero();
  for (int kb = k0; kb < k1; kb += kWarpRuns) {
    int e[kWarpRounds];
#pragma unroll
    for (int i = 0; i < kWarpRounds; ++i) {
      const int k = kb + 32 * i + lane;
      e[i] = k < k1 ? __ldg(plan.row_runs + k) : 0;
    }
    wait_for_panel_stage();
#pragma unroll
    for (int i = 0; i < kWarpRounds; ++i) {
      const int k = kb + 32 * i + lane;
      sv[32 * i + lane] = k < k1 ? run_vals[e[i] & kIdMask] : O::zero();
      const unsigned opens = __ballot_sync(0xffffffffu, e[i] < 0);
      if (lane == 0) so[i] = opens;
    }
    __syncwarp();
    if (lane == 0) fold_runs<SR>(sv, so, min(kWarpRuns, k1 - kb), total, part);
    __syncwarp();
  }
  wait_for_panel_stage();  // also where the row has no run
  return __shfl_sync(0xffffffffu, k0 < k1 ? O::add(total, part) : total, 0);
}

// Blocks [0, piece_blocks): one warp per overflow piece k, whose value goes
// to piece_vals[k]. Pieces are in owner order, so the first warp of each
// owner in a block adds how many of its pieces the block holds to that
// owner's count; the block that completes an owner (the count, reset
// there, only says who folds: the order of ⊕ is fixed) stages the owner's
// piece values with all its threads, kRowStage at a time, and one thread
// folds them in order: out[r] = dp[r] ⊕ (identity ⊕ each piece, one after
// another). Then one thread per other output row, out[r] = dp[r].
template <int SR>
__global__ void __launch_bounds__(kRowThreads)
sell2_row_kernel(const Sell2Plan plan, const typename Op<SR>::T* run_vals,
                 typename Op<SR>::T* __restrict__ piece_vals,
                 typename Op<SR>::T* __restrict__ out) {
  using O = Op<SR>;
  using T = typename O::T;
  __shared__ __align__(16) T stage[kRowStage];
  __shared__ unsigned stage_opens[kRowWarps][kWarpRounds];
  __shared__ int block_slot[kRowWarps], completes[kRowWarps];
  __shared__ T own_value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int piece_blocks = (plan.n_pieces + kRowWarps - 1) / kRowWarps;
  if (static_cast<int>(blockIdx.x) < piece_blocks) {
    const int k = blockIdx.x * kRowWarps + warp;
    const int o = k < plan.n_pieces ? __ldg(plan.piece_slot + k) : -1;
    if (k < plan.n_pieces) {
      const T v = warp_row_value<SR>(plan, run_vals, plan.base_pad + k, lane,
                                     stage + warp * kWarpRuns, stage_opens[warp]);
      if (lane == 0) {
        piece_vals[k] = v;
        __threadfence();
      }
    } else {
      wait_for_panel_stage();
    }
    if (lane == 0) block_slot[warp] = o;
    __syncthreads();
    if (lane == 0) {
      int last = 0;
      if (o >= 0 && (warp == 0 || block_slot[warp - 1] != o)) {
        int held = 1;
        while (warp + held < kRowWarps && block_slot[warp + held] == o) ++held;
        const int* ow = plan.owners + 3 * o;
        last = atomicAdd(plan.owner_done + o, held) == __ldg(ow + 2) - __ldg(ow + 1) - held;
      }
      completes[warp] = last;
    }
    __syncthreads();
    for (int w = 0; w < kRowWarps; ++w) {  // block-uniform
      if (!completes[w]) continue;
      __threadfence();
      const int* ow = plan.owners + 3 * block_slot[w];
      const int owner = __ldg(ow), p0 = __ldg(ow + 1), p1 = __ldg(ow + 2);
      T seg = O::identity();
      if (tid == 32) own_value = row_value<SR>(plan, run_vals, owner);  // beside the fold
      for (int kb = p0; kb < p1; kb += kRowStage) {
#pragma unroll
        for (int i = 0; i < kRowStage / kRowThreads; ++i) {
          const int j = kb + i * kRowThreads + tid;
          stage[i * kRowThreads + tid] = j < p1 ? __ldcg(piece_vals + j) : O::identity();
        }
        __syncthreads();
        if (tid == 0) seg = fold_values<SR>(stage, min(kRowStage, p1 - kb), seg);
        __syncthreads();
      }
      if (tid == 0) {
        out[owner] = O::add(own_value, seg);
        plan.owner_done[block_slot[w]] = 0;  // ready for the next call
      }
      __syncthreads();  // own_value and stage are free again
    }
    return;
  }
  const int r = (blockIdx.x - piece_blocks) * kRowThreads + tid;
  if (r >= plan.n_final || ((__ldg(plan.owner_bits + (r >> 5)) >> (r & 31)) & 1u)) {
    wait_for_panel_stage();  // every thread ends after the panel stage
    return;
  }
  out[r] = row_value<SR>(plan, run_vals, r);
}

struct Sell2Launch {
  const Sell2Plan& plan;
  const void* x;
  long long n_x;
  void* buf;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    T* out = static_cast<T*>(buf);
    T* run_vals = out + plan.n_final;
    T* piece_vals = run_vals + plan.n_runs;
    if (plan.n_blocks > 0) {
      sell2_panel_kernel<SR, S><<<plan.n_blocks, kPanelThreads, 0, stream>>>(
          plan, static_cast<const T*>(x), n_x, run_vals);
      const int rc = cudaGetLastError();
      if (rc != cudaSuccess) return rc;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((plan.n_pieces + kRowWarps - 1) / kRowWarps +
                          (plan.n_final + kRowThreads - 1) / kRowThreads);
    config.blockDim = dim3(kRowThreads);
    config.stream = stream;
    cudaLaunchAttribute overlap[1];
    overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    overlap[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = overlap;
    config.numAttrs = 1;
    const T* run_vals_in = run_vals;
    return cudaLaunchKernelEx(&config, sell2_row_kernel<SR>, plan, run_vals_in, piece_vals, out);
  }
};

}  // namespace

extern "C" {

// The sell2 dp. plan is the operand's launch (ops/sell2.py:_Launch); x the
// carrier-typed vector of n_x entries; buf holds n_final + n_runs +
// n_pieces carrier values: the output rows (the dp, with the pieces folded
// into their owners), then scratch for the run and piece values. semiring
// and the plan's value type pick the instantiation; with no panel block
// the value type is the carrier's. Calls on one plan must run in stream
// order (its owner counts). Launches on `stream` and returns the first
// cudaError_t (0 on success); it does not synchronise.
int sh_sell2_dp(const Sell2Plan* plan, const void* x, long long n_x, void* buf, int semiring,
                void* stream) {
  if (plan == nullptr || n_x < 0 || plan->n_blocks < 0 || plan->n_runs < 0 ||
      plan->n_pieces < 0 || plan->n_final <= 0)
    return cudaErrorInvalidValue;
  int rc = cudaSetDevice(plan->device);
  if (rc != cudaSuccess) return rc;
  int val_dtype = plan->val_dtype;
  if (val_dtype < 0)
    val_dtype = (semiring == OR_AND || semiring == MAX_RIGHT || semiring == MIN_RIGHT)
                    ? STRIP_I32 : STRIP_F32;
  const Sell2Launch launch{*plan, x, n_x, buf, static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, val_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
