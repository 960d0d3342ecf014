// Ragged (sell2) semiring SpMV dp over (128, 128) panels, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel sparseharness_tpu/ops/pallas_sell2.py:
// _panel_call (kernel body at :926), one pallas_call per (slab, bucket)
// layout. On the TPU every step is a (128, 128) crossbar: x staging by
// chunk, ⊗, an align crossbar, an XOR butterfly with capture masks, route
// crossbars, and ⊕ into the slab's out tile across a sequential grid. Here
// the crossbars become plain indexing, and the sequential out-tile ⊕
// becomes a run table (sparseharness_tpu_torch/ops/sell2.py:make_plan,
// decoded once on the device from wordA and wordB).
//
// What it computes. Panel p (of any layout; layouts are reached through a
// table of pointers, so one launch covers every layout), stream slot
// (s, l), with b = wordB[p·128 + s, l] and the sublane's bindings
// i = wordB[p·128 + 0, s]:
//   c  = chunk[p, (i >> 30) & 1]
//   blk = (b >> 29) & 1 ? (i >> 15) & 127 : (i >> 22) & 127
//   x  = c < n_chunks ? x[c·16384 + blk·128 + (b & 127)]
//                     : x[virt_blocks[c − n_chunks, blk]·128 + (b & 127)]
//        (0̄ past the end of x, as the TPU's zero-padded x)
//   contrib[s, l] = x ⊗ vals[p·128 + s, l]
// A run (row-class l, aligned offset off, level v) is the ⊕ of
// contrib[a(j), l] over j in [off, off + 2^v), a(j) the align sublane of
// wordA[p·128 + l, j mod 128] (bits 0–6 below slot 128, 7–13 above), taken
// in the butterfly's pairwise order. Padding slots name sublane 127, whose
// values are 0̄, so their products enter every run exactly as on the TPU.
// Each dp row then ⊕-accumulates its runs: 0̄ ⊕ the runs of one layout, in
// panel order, and these per-layout partials ⊕-combined in layout order,
// as the TPU's out tiles are. Overflow pieces of split rows are folded
// into their owner row last, one piece after another.
//
// Kernels: (1) a block of 512 threads per panel computes the panel's
// 16,384 products into shared memory (64 KB; wordB and vals read once,
// coalesced, x gathered through L2), then one thread per run reduces it
// and writes its value to the run's place in the row-sorted run list;
// (2) a thread per dp row ⊕-reduces its runs in order; (3) a thread per
// owner row folds its pieces. Every ⊕ has a fixed order and no atomics, so
// plus_times gives the same bits on every run and equals the plain torch
// version's bits.
//
// What bounds it: the bytes of the panel stream (12 B a slot in f32,
// 10 B in bf16; 2 slots per nonzero on power-law structure), plus the run
// table this design adds (about 16 B per run) and x through L2. The
// operations, one ⊗ and about one ⊕ per slot, are far below the card's.
//
// Semirings, loads and bit-exactness: semiring.cuh.

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kLanes = 128;
constexpr int kPanelSlots = kLanes * kLanes;
constexpr int kChunkCols = kLanes * kLanes;
constexpr int kPanelThreads = 512;

__device__ __forceinline__ float load_val(const float* p) { return __ldcs(p); }
__device__ __forceinline__ int load_val(const int* p) { return __ldcs(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int SR, typename S>
__global__ void __launch_bounds__(kPanelThreads)
sell2_panel_kernel(const long long* __restrict__ layout_ptrs,
                   const int* __restrict__ panel_layout,
                   const int* __restrict__ panel_local,
                   const int* __restrict__ panel_run_ptr,
                   const int* __restrict__ run_info, const int* __restrict__ run_dest,
                   const typename Op<SR>::T* __restrict__ x, long long n_x,
                   const int* __restrict__ virt_blocks, int n_chunks,
                   typename Op<SR>::T* __restrict__ run_vals) {
  using O = Op<SR>;
  using T = typename O::T;
  extern __shared__ unsigned char smem_raw[];
  T* contrib = reinterpret_cast<T*>(smem_raw);  // [s·128 + l]
  __shared__ int bindings[kLanes];

  const int g = blockIdx.x;
  const long long* lp = layout_ptrs + 4 * static_cast<long long>(__ldg(panel_layout + g));
  const long long p = __ldg(panel_local + g);
  const int* chunk = reinterpret_cast<const int*>(lp[0]) + 2 * p;
  const int* wa = reinterpret_cast<const int*>(lp[1]) + p * kPanelSlots;
  const int* wb = reinterpret_cast<const int*>(lp[2]) + p * kPanelSlots;
  const S* vals = reinterpret_cast<const S*>(lp[3]) + p * kPanelSlots;
  const int c0 = __ldg(chunk), c1 = __ldg(chunk + 1);
  if (threadIdx.x < kLanes) bindings[threadIdx.x] = __ldg(wb + threadIdx.x);
  __syncthreads();

  for (int i = threadIdx.x; i < kPanelSlots; i += kPanelThreads) {
    const int b = __ldcs(wb + i);
    const int bind = bindings[i >> 7];
    const int c = ((bind >> 30) & 1) ? c1 : c0;
    const int blk = ((b >> 29) & 1) ? ((bind >> 15) & 127) : ((bind >> 22) & 127);
    long long base;
    if (c < n_chunks) {
      base = static_cast<long long>(c) * kChunkCols + blk * kLanes;
    } else {
      base = static_cast<long long>(
                 __ldg(virt_blocks + static_cast<long long>(c - n_chunks) * kLanes + blk)) *
             kLanes;
    }
    const long long xi = base + (b & 127);
    const T xv = xi < n_x ? __ldg(x + xi) : O::zero();
    contrib[i] = O::mul(xv, static_cast<T>(load_val(vals + i)));
  }
  __syncthreads();

  const int r1 = __ldg(panel_run_ptr + g + 1);
  for (int r = __ldg(panel_run_ptr + g) + threadIdx.x; r < r1; r += kPanelThreads) {
    const int info = __ldg(run_info + r);
    const int l = info & 127;
    const int w = 1 << ((info >> 15) & 7);
    const int first = ((info >> 7) & 255) & ~(w - 1);
    const int* arow = wa + l * kLanes;
    // pairwise ⊕ in the butterfly's order: after slot i, merge once per
    // trailing one bit of i (a binary counter of partial sums)
    T stack[8];
    int top = 0;
    for (int i = 0; i < w; ++i) {
      const int j = first + i;
      const int word = __ldg(arow + (j & 127));
      const int a = j < kLanes ? (word & 127) : ((word >> 7) & 127);
      T v = contrib[a * kLanes + l];
      for (int m = i; m & 1; m >>= 1) v = O::add(stack[--top], v);
      stack[top++] = v;
    }
    run_vals[__ldg(run_dest + r)] = stack[0];
  }
}

// dp[r] = 0̄ ⊕ (per-layout partials of row r's runs, in order)
template <int SR>
__global__ void __launch_bounds__(kThreads)
sell2_row_kernel(const int* __restrict__ row_ptr, const typename Op<SR>::T* __restrict__ run_vals,
                 const int* __restrict__ run_layout, typename Op<SR>::T* __restrict__ dp,
                 int n_out) {
  using O = Op<SR>;
  using T = typename O::T;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_out) return;
  const int k0 = __ldg(row_ptr + r), k1 = __ldg(row_ptr + r + 1);
  T total = O::zero();
  if (k0 < k1) {
    int layout = __ldg(run_layout + k0);
    T part = O::add(O::zero(), __ldg(run_vals + k0));
    for (int k = k0 + 1; k < k1; ++k) {
      const int next = __ldg(run_layout + k);
      if (next != layout) {
        total = O::add(total, part);
        part = O::zero();
        layout = next;
      }
      part = O::add(part, __ldg(run_vals + k));
    }
    total = O::add(total, part);
  }
  dp[r] = total;
}

// out[r] = dp[r] ⊕ (identity ⊕ pieces of owner r, one after another)
template <int SR>
__global__ void __launch_bounds__(kThreads)
sell2_fold_kernel(const int* __restrict__ piece_ptr, const typename Op<SR>::T* __restrict__ dp,
                  typename Op<SR>::T* __restrict__ out, int base_pad) {
  using O = Op<SR>;
  using T = typename O::T;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= base_pad) return;
  T seg = O::identity();
  const int k1 = __ldg(piece_ptr + r + 1);
  for (int k = __ldg(piece_ptr + r); k < k1; ++k) seg = O::add(seg, dp[base_pad + k]);
  out[r] = O::add(dp[r], seg);
}

struct Sell2Launch {
  const long long* layout_ptrs;
  const int *panel_layout, *panel_local, *panel_run_ptr, *run_info, *run_dest,
      *run_layout, *row_ptr, *piece_ptr;
  const void* x;
  long long n_x;
  const int* virt_blocks;
  int n_chunks;
  void *run_vals, *dp, *out;
  int n_panels, n_out, base_pad;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const size_t smem = kPanelSlots * sizeof(T);
    if (n_panels > 0) {
      static bool attr_set = false;  // one per instantiation
      if (!attr_set) {
        const int rc = cudaFuncSetAttribute(sell2_panel_kernel<SR, S>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(smem));
        if (rc != cudaSuccess) return rc;
        attr_set = true;
      }
      sell2_panel_kernel<SR, S><<<n_panels, kPanelThreads, smem, stream>>>(
          layout_ptrs, panel_layout, panel_local, panel_run_ptr, run_info, run_dest,
          static_cast<const T*>(x), n_x, virt_blocks, n_chunks, static_cast<T*>(run_vals));
      const int rc = cudaGetLastError();
      if (rc != cudaSuccess) return rc;
    }
    if (n_out > 0) {
      sell2_row_kernel<SR><<<(n_out + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          row_ptr, static_cast<const T*>(run_vals), run_layout, static_cast<T*>(dp), n_out);
      const int rc = cudaGetLastError();
      if (rc != cudaSuccess) return rc;
    }
    if (base_pad > 0) {
      sell2_fold_kernel<SR><<<(base_pad + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          piece_ptr, static_cast<const T*>(dp), static_cast<T*>(out), base_pad);
    }
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// The sell2 dp. layout_ptrs is the int64 (L, 4) table of each launched
// layout's chunk, wordA, wordB and vals pointers; the other tables are
// the int32 arrays of ops/sell2.py:Sell2Plan. x is the carrier-typed
// vector of n_x entries. Writes run_vals (one per run), dp (n_out rows)
// and, with base_pad > 0, out (base_pad rows: dp with the pieces folded).
// Launches on `stream` and returns the first cudaError_t (0 on success);
// it does not synchronise.
int sh_sell2_dp(int device, const void* layout_ptrs, const void* panel_layout,
                const void* panel_local, const void* panel_run_ptr, const void* run_info,
                const void* run_dest, const void* run_layout, const void* row_ptr,
                const void* piece_ptr, const void* x, long long n_x,
                const void* virt_blocks, int n_chunks, void* run_vals, void* dp,
                void* out, int n_panels, int n_out, int base_pad, int semiring,
                int val_dtype, void* stream) {
  if (n_panels < 0 || n_out < 0 || base_pad < 0 || n_x < 0 || n_chunks <= 0)
    return cudaErrorInvalidValue;
  if (base_pad > 0 && piece_ptr == nullptr) return cudaErrorInvalidValue;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const Sell2Launch launch{
      static_cast<const long long*>(layout_ptrs), static_cast<const int*>(panel_layout),
      static_cast<const int*>(panel_local), static_cast<const int*>(panel_run_ptr),
      static_cast<const int*>(run_info), static_cast<const int*>(run_dest),
      static_cast<const int*>(run_layout), static_cast<const int*>(row_ptr),
      static_cast<const int*>(piece_ptr), x, n_x, static_cast<const int*>(virt_blocks),
      n_chunks, run_vals, dp, out, n_panels, n_out, base_pad,
      static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, val_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
