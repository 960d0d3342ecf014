// Ragged (sell2) semiring SpMV dp, row-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparseharness_tpu/ops/pallas_sell2.py:
// _panel_call (kernel body at :926), one pallas_call per (slab, bucket)
// layout. On the TPU every step is a (128, 128) crossbar over the panel
// stream: x staging by chunk, ⊗, an align crossbar, an XOR butterfly with
// capture masks, route crossbars, and ⊕ into the slab's out tile. A panel
// holds about three slots for each real entry, and a row's entries are cut
// into runs that lie in as many panels. Here the gather is done once, in the
// plan: sparseharness_tpu_torch/ops/sell2.py:make_plan takes the (dp row, x
// column, value) entries that build_sell2 packs into the panels and stores
// each dp row's pairs contiguously, by column. A call reads that stream in
// order and reduces each row in registers.
//
// What it computes. Position i is dp row row_dest[i] (an output row) or
// overflow piece row_dest[i] − n_final, with entries [row_ptr[i],
// row_ptr[i + 1]) of cols and vals: its value is 0̄ ⊕ (x[col] ⊗ val over
// them). The owner of a split row's pieces has its own row at a position
// in no bin, and its output is that row's value ⊕ (identity ⊕ each of its
// pieces, one after another), as dp_sell2_plain folds them. Dropping the
// pads changes nothing where 0̄ ⊕ (x ⊗ 0̄) = 0̄, which holds for every
// finite x but min_plus x below about −2^103 (the plain version's pad
// reads x at its chunk's first column).
//
// The design. One launch a call. The plan groups positions in bins of like
// length, widest first; a bin's rows are taken by 32, 16, 8, 4, 2 or 1
// lanes (kBinLanes). A lane takes 4 entries at once: the 16-byte chunk of
// columns and of values (8 bytes in bf16) that holds them, with an
// evict-first load, so that the stream, read once, leaves x and the output
// in L2; x is gathered through the read-only path, where L1 keeps the hub
// columns that power-law rows share. Each lane ⊕-accumulates its chunks in
// order from 0̄, then the row's lanes combine by __shfl_xor_sync with lane
// masks V/2, ..., 1: a fixed order, so two calls give the same bits. A
// piece's warp writes its value to scratch; the warp that finishes an
// owner's last piece (a count per owner, which only says who folds)
// reduces the owner's own row, then loads its piece values, 256 at a time,
// and folds them in piece order. Pieces come first in bin 0, so those
// folds end early in the launch. The launch is a programmatic dependent
// one: it reads its plan before it waits for the previous launch, and x
// and the output after.
//
// The bins' bounds (ops/sell2.py:BIN_MAX_LEN: at most 4, 8, 16, 32 and 64
// entries for 1 to 16 lanes, longer rows and every piece for a warp) give
// each lane one to three chunks of a row. Halving or doubling them all
// moved the kernel by at most 4% at both shapes below
// (scripts/probe_sell2_bins_cuda.py).
//
// The x order. Where numbering the columns by how many entries read them
// brings more than two entries a column of x into x's first 65,536
// columns (the 256 KB an SM's L1 holds), more of the kernel's gathers than
// the copy costs (ops/sell2.py:degree_rank, X_COPY_GATHERS), the plan
// takes that numbering (col_perm[new] = old), and a call first launches
// sell2_x_kernel, which writes xo = x in that order into the scratch past
// the pieces'; the kernel then gathers from xo. On a graph with permuted labels the hub
// columns lie scattered over x, one to a 128-byte line; in xo the 65,536
// most read ones share the first 256 KB (81% of the Kronecker graph's
// entries against 6% before), and the 16,384 most read are dealt one to a
// line in turn over its first 64 KB (ops/sell2.py:HOT_COLS), which timed
// better than ranks side by side at the Kronecker graph: 0.2685 against
// 0.2845 ms with the graph's seed 0, 0.2715 against 0.3095 with seed 1
// (ranks side by side lost to x as is there); at edgefactor 4 and at scale
// 17 the layouts read within 2–5% of each other.
//
// What bounds it. The stream, 8 bytes an entry in f32 (6 in bf16), the
// row pointers and destinations, x and the output once: about 77 µs at
// 3.35 TB/s at the Graph500 Kronecker graph of scale 20 (31.4 M entries).
// Then one gather an entry: before the x order, one 32-byte L2 sector
// request an entry, about as much again as the stream (0.297 ms a call,
// 0.139 with every gather sent to x[0]); in the order most of them hit L1,
// and the gathers still cost about 0.13 ms. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W, f32 plus_times, in turns with x as it is
// (scripts/probe_sell2_bins_cuda.py --x-order): at the Kronecker graph
// the kernel 0.2685 ms and the copy 0.0065, a call 0.2752–0.2770 against
// 0.3034 (the design before the row-major plan, a panel and a row stage
// over the TPU's panels, 0.591; cuSPARSE's CSR SpMV 0.262). The rule's
// count, entries brought into the first 65,536 columns per column of x,
// against a call in order and as is: the Kronecker graph 22.5; scale 17
// (28 entries a column) 14.1, 0.0325–0.0326 against 0.0347–0.0349 ms;
// scale 20 with edgefactor 4 (7.8 a column) 5.9, 0.0809 against 0.0868,
// and 3 (5.9 a column) 4.5, 0.0617–0.0626 against 0.0676–0.0681; scale
// 16, whose x fits in L1, 0, 0.0181 against 0.0182–0.0185;
// power_law_coo(500000, 2000000, alpha=1.5, seed=13), 3.4 a column, whose
// generator already numbers the columns by popularity, 0.24, 0.0214–0.0215
// against 0.0188–0.0191 (the copy, 3 µs, and no gain). A rank's block of
// the Kronecker graphs (all of x's columns, fewer entries), about: scale 20
// on 4 ranks 5.7, 0.0736–0.0785 against 0.0770–0.0801; edgefactor 4 on 2
// ranks 3.0, 0.0455–0.0460 against 0.0458–0.0470; edgefactor 3 on 2 ranks
// 2.2, 0.0338–0.0353 against 0.0348–0.0372; edgefactor 4 on 4 ranks 1.5,
// 0.0258–0.0293 against 0.0235–0.0253; edgefactor 3 on 4 ranks 1.1,
// 0.0230–0.0298 against 0.0199–0.0267. So the copy, 5–7 µs at 1 M
// columns, costs about two of the kernel's gathers a column, and the rule
// keeps x as it is on the ragged matrix: a kernel of 0.0167–0.0184 ms,
// where the host's enqueue, 0.015–0.026 ms, often sets the call. Without
// the fence before a piece's count (which the fold needs) the Kronecker
// kernel took 0.278 ms against 0.297. An earlier
// design wrote each run value of the panels at its row-order place on
// every call, and those scattered 4-byte stores cost more than the row
// gather they replaced; here the reorder is made once, in the plan, and a
// call stores only the output and xo.
//
// Semirings, loads and bit-exactness: semiring.cuh. plus_times sums in
// another order than the plain version, so it is held to a tolerance.

#include "semiring.cuh"

constexpr int kSell2Bins = 6;

// The launch as ops/sell2.py:_Launch holds it, made once per operand.
struct Sell2Plan {
  const int* row_ptr;              // (n_positions + O + 1,): binned, then the owners'
  const int* row_dest;             // (n_positions + O,): output row, or n_final + piece
  const int* cols;                 // (n_slots,), n_slots a multiple of 4
  const void* vals;                // (n_slots,), the store type
  const int* owners;               // (O, 3): owner row, pieces [k0, k1)
  const int* piece_slot;           // (n_pieces,): each piece's owner in owners
  int* owner_done;                 // (O,): pieces done this call, 0 between calls
  const int* col_perm;             // (n_perm,): x column of each of cols' ids, or null
  int bin_pos[kSell2Bins + 1];     // first position of each bin
  int bin_block[kSell2Bins + 1];   // first block of each bin
  int n_final, n_pieces, n_perm, val_dtype, device;
};

namespace {

using namespace sh;

constexpr int kRowThreads = 256;                              // as ops/sell2.py:ROW_THREADS
constexpr int kBinLanes[kSell2Bins] = {32, 16, 8, 4, 2, 1};  // as ops/sell2.py:BIN_LANES
constexpr int kFoldRounds = 8;  // piece values a lane loads at once in an owner's fold
constexpr int kXThreads = 256;  // threads of a block of the x copy

// Programmatic dependent launch (sm_90): every thread waits here, after
// loading its plan, until the previous launch's writes are visible. x
// passes through the wait's asm, so the compiler cannot issue a load
// through it above the wait.
template <typename T>
__device__ __forceinline__ const T* wait_for_previous_launch(const T* x) {
  uint64_t p = reinterpret_cast<uint64_t>(x);
  asm volatile("griddepcontrol.wait;" : "+l"(p) : : "memory");
  return reinterpret_cast<const T*>(p);
}

// x in the plan's column order: xo[j] = x[col_perm[j]], 0̄ where that
// column lies past x's end. A thread a column; the permutation is read
// before the wait, x after it.
template <int SR>
__global__ void __launch_bounds__(kXThreads)
sell2_x_kernel(const int* __restrict__ col_perm, int n_perm,
               const typename Op<SR>::T* __restrict__ x, long long n_x,
               typename Op<SR>::T* __restrict__ xo) {
  const int j = static_cast<int>(blockIdx.x) * kXThreads + static_cast<int>(threadIdx.x);
  const int c = j < n_perm ? __ldg(col_perm + j) : 0;
  x = wait_for_previous_launch(x);
  if (j < n_perm) xo[j] = c < n_x ? __ldg(x + c) : Op<SR>::zero();
}

// 0̄ ⊕ (x[col] ⊗ val over entries [k0, k1)), by V lanes: lane `sub` takes
// chunks sub, sub + V, ... of the row and accumulates them in order from
// 0̄; then the lanes combine, every lane getting the value
template <int SR, typename S, int V>
__device__ __forceinline__ typename Op<SR>::T row_value(
    const Sell2Plan& plan, const typename Op<SR>::T* __restrict__ x, long long n_x, int k0,
    int k1, int sub) {
  using O = Op<SR>;
  using T = typename O::T;
  const int4* cols = static_cast<const int4*>(static_cast<const void*>(plan.cols));
  const S* vals = static_cast<const S*>(plan.vals);
  T acc = O::zero();
  const int c1 = (k1 + 3) >> 2;
  for (int c = (k0 >> 2) + sub; c < c1; c += V) {
    const int4 col = __ldcs(cols + c);
    T a[4];
    load_strip4(vals + 4 * static_cast<long long>(c), a);
    const int cc[4] = {col.x, col.y, col.z, col.w};
    T xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * c + i;
      xv[i] = e >= k0 && e < k1 && cc[i] < n_x ? __ldg(x + cc[i]) : O::zero();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * c + i;
      if (e >= k0 && e < k1) acc = O::add(acc, O::mul(xv[i], a[i]));
    }
  }
#pragma unroll
  for (int m = V / 2; m > 0; m >>= 1) acc = O::add(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  return acc;
}

// Overflow piece k's value v, by its warp: written to scratch, counted to
// its owner; the warp that counts the owner's last piece reduces the
// owner's own row and folds the owner's pieces in order, out[owner] =
// own ⊕ (identity ⊕ each piece), and sets the count back to 0 for the next
// call
template <int SR, typename S>
__device__ __forceinline__ void fold_piece(const Sell2Plan& plan,
                                           const typename Op<SR>::T* __restrict__ x,
                                           long long n_x, typename Op<SR>::T* buf, int k,
                                           typename Op<SR>::T v, int lane) {
  using O = Op<SR>;
  using T = typename O::T;
  const int o = __ldg(plan.piece_slot + k);
  const int* ow = plan.owners + 3 * o;
  const int owner = __ldg(ow), p0 = __ldg(ow + 1), p1 = __ldg(ow + 2);
  int last = 0;
  if (lane == 0) {
    buf[plan.n_final + k] = v;
    __threadfence();
    last = atomicAdd(plan.owner_done + o, 1) == p1 - p0 - 1;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  const int own_pos = plan.bin_pos[kSell2Bins] + o;  // the owner's own row, in no bin
  const T own = row_value<SR, S, 32>(plan, x, n_x, __ldg(plan.row_ptr + own_pos),
                                     __ldg(plan.row_ptr + own_pos + 1), lane);
  const T* pieces = buf + plan.n_final;
  T seg = O::identity();
  for (int kb = p0; kb < p1; kb += 32 * kFoldRounds) {
    T pv[kFoldRounds];
#pragma unroll
    for (int r = 0; r < kFoldRounds; ++r) {
      const int j = kb + 32 * r + lane;
      pv[r] = j < p1 ? __ldcg(pieces + j) : O::identity();
    }
#pragma unroll
    for (int r = 0; r < kFoldRounds; ++r) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const T t = __shfl_sync(0xffffffffu, pv[r], j);
        if (kb + 32 * r + j < p1) seg = O::add(seg, t);
      }
    }
  }
  if (lane == 0) {
    buf[owner] = O::add(own, seg);
    plan.owner_done[o] = 0;
  }
}

// The block's rows of bin BIN: kRowThreads / V positions, V lanes each
template <int SR, typename S, int BIN>
__device__ __forceinline__ void bin_rows(const Sell2Plan& plan,
                                         const typename Op<SR>::T* __restrict__ x,
                                         long long n_x, typename Op<SR>::T* buf) {
  constexpr int V = kBinLanes[BIN];
  const int tid = threadIdx.x;
  const int pos = plan.bin_pos[BIN] +
                  (static_cast<int>(blockIdx.x) - plan.bin_block[BIN]) * (kRowThreads / V) +
                  tid / V;
  const bool live = pos < plan.bin_pos[BIN + 1];
  int k0 = 0, k1 = 0, dest = 0;
  if (live) {
    k0 = __ldg(plan.row_ptr + pos);
    k1 = __ldg(plan.row_ptr + pos + 1);
    dest = __ldg(plan.row_dest + pos);
  }
  x = wait_for_previous_launch(x);
  const auto v = row_value<SR, S, V>(plan, x, n_x, k0, k1, tid & (V - 1));
  if (!live) return;
  if constexpr (V == 32) {
    if (dest >= plan.n_final) {  // warp-uniform: the warp's one row is a piece
      fold_piece<SR, S>(plan, x, n_x, buf, dest - plan.n_final, v, tid & 31);
      return;
    }
  }
  if ((tid & (V - 1)) == 0) buf[dest] = v;
}

// One launch a call: blocks [bin_block[k], bin_block[k + 1]) take bin k
template <int SR, typename S>
__global__ void __launch_bounds__(kRowThreads)
sell2_dp_kernel(const Sell2Plan plan, const typename Op<SR>::T* __restrict__ x, long long n_x,
                typename Op<SR>::T* buf) {
  const int b = blockIdx.x;
  if (b < plan.bin_block[1]) bin_rows<SR, S, 0>(plan, x, n_x, buf);
  else if (b < plan.bin_block[2]) bin_rows<SR, S, 1>(plan, x, n_x, buf);
  else if (b < plan.bin_block[3]) bin_rows<SR, S, 2>(plan, x, n_x, buf);
  else if (b < plan.bin_block[4]) bin_rows<SR, S, 3>(plan, x, n_x, buf);
  else if (b < plan.bin_block[5]) bin_rows<SR, S, 4>(plan, x, n_x, buf);
  else bin_rows<SR, S, 5>(plan, x, n_x, buf);
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
    const int blocks = plan.bin_block[kSell2Bins];
    if (blocks == 0) return cudaSuccess;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(kRowThreads);
    config.stream = stream;
    cudaLaunchAttribute overlap[1];
    overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    overlap[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = overlap;
    config.numAttrs = 1;
    const T* x_in = static_cast<const T*>(x);
    long long n_in = n_x;
    T* out = static_cast<T*>(buf);
    if (plan.col_perm != nullptr) {
      // x into the plan's column order, in the scratch past the pieces'
      T* xo = out + plan.n_final + plan.n_pieces;
      config.gridDim = dim3((plan.n_perm + kXThreads - 1) / kXThreads);
      config.blockDim = dim3(kXThreads);
      const int rc = cudaLaunchKernelEx(&config, sell2_x_kernel<SR>, plan.col_perm,
                                        plan.n_perm, x_in, n_x, xo);
      if (rc != cudaSuccess) return rc;
      x_in = xo;
      n_in = plan.n_perm;
      config.gridDim = dim3(blocks);
      config.blockDim = dim3(kRowThreads);
    }
    return cudaLaunchKernelEx(&config, sell2_dp_kernel<SR, S>, plan, x_in, n_in, out);
  }
};

}  // namespace

extern "C" {

// The sell2 dp. plan is the operand's launch (ops/sell2.py:_Launch); x the
// carrier-typed vector of n_x entries (a column past its end reads 0̄);
// buf holds n_final + n_pieces + n_perm carrier values: the output rows
// (the dp, with the pieces folded into their owners), then scratch for the
// piece values and for x in the plan's column order. semiring and the
// plan's value type pick the instantiation; with no entry the value type
// is the carrier's. Calls on one plan must run in stream order (its owner
// counts). Launches on `stream` (the x copy where the plan has col_perm,
// then the kernel) and returns the first cudaError_t (0 on success); it
// does not synchronise.
int sh_sell2_dp(const Sell2Plan* plan, const void* x, long long n_x, void* buf, int semiring,
                void* stream) {
  if (plan == nullptr || n_x < 0 || plan->n_pieces < 0 || plan->n_final <= 0 ||
      plan->n_perm < 0 || (plan->col_perm != nullptr) != (plan->n_perm > 0))
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
