// The sell design record's two kernels, for Hopper (sm_90a): phase A
// (the contrib stream) and a gather-reduce level.
//
// Replaces the Pallas TPU kernels of sparseharness_tpu/ops/pallas_sell.py:
// _phase_a_call (kernel :330) and _level_call (kernel :361). On the TPU each
// is one call per slab (and per level): 1 + levels calls per slab. Here one
// phase-A launch covers every slab's stream, and one level launch per level
// depth covers every slab that has that level, driven by a launch table
// that the operand's build derives once from the layouts
// (ops/sell.py:launch_table).
//
// Phase A, one thread per stream slot (s, j):
//   contrib[s, j] = mul(x2d[blocksel[s], lanesel[s, j]], vals[s, j])
// written to the first rows of the work buffer (every slab's stream
// concatenated). x2d is at most 2048 × 128 (1 MB f32) and stays in L2, so it
// is read where it lies; the stream is read once with streaming loads.
//
// A level, one block per output row and one thread per lane j:
//   z[s, j] = src[idx[s, j], j] (src rows past its real count read 0̄, as the
//   TPU kernel's source padded with 0̄ does), then in region (w, s0, s1) the
//   output row q is z[s0 + q·w] ⊕ z[s0 + q·w + 1] ⊕ ... ⊕ z[s0 + q·w + w − 1],
//   folded left to right as the TPU kernel's acc = zr[0::w]; acc = add(acc,
//   zr[t::w]) does. A non-final level writes its rows into the work buffer,
//   where the next level reads them; a final level writes the slab's rows in
//   canonical order into the dp at row0 / 128.
//
// What bounds it: bytes. Phase A reads lanesel, vals and blocksel once and
// writes the contrib stream; a level reads its idx array once and gathers
// one source element per idx slot, lane-preserving, so a warp's 32 lanes
// read 32 consecutive elements of one source row. The contrib stream and
// the level outputs are intermediates that a fused kernel need not write
// (later work).
//
// Bit-exactness: the products are rounded to the carrier type and stored
// by phase A before any ⊕, in a separate kernel, so nothing contracts into
// an FMA, and each level ⊕-folds in the TPU kernel's order: every semiring,
// plus_times included, gives the plain torch version's bits. No atomics.
//
// Semirings and loads: semiring.cuh.

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kLanes = 128;
constexpr int kEntryWords = 24;  // as ops/sell.py:ENTRY_WORDS

// one (slab, level) row of the launch table, as ops/sell.py:launch_table
enum EntryField {
  ROW_BEGIN = 0,  // first output row of the entry within its depth's launch
  D_OUT = 1,      // output rows
  SRC_OFF = 2,    // source: first row in the work buffer
  SRC_ROWS = 3,   // source rows; idx past them reads 0̄
  IDX_OFF = 4,    // first row of the entry's idx array in the flat idx
  OUT_OFF = 5,    // first output row, in the work buffer or (final) the dp
  FINAL = 6,      // 1: write the dp
  N_REGIONS = 7,
  REGIONS = 8,    // 4 × (w, s0, out row begin, out row end), one per run width
};

template <int SR, typename S>
__global__ void __launch_bounds__(kThreads)
sell_phase_a_kernel(const typename Op<SR>::T* __restrict__ x2d, const int* __restrict__ lanesel,
               const S* __restrict__ vals, const int* __restrict__ blocksel,
               typename Op<SR>::T* __restrict__ contrib, int64_t n_slots) {
  using O = Op<SR>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const int64_t s = i / kLanes;
  const int64_t col = static_cast<int64_t>(__ldg(blocksel + s)) * kLanes + __ldcs(lanesel + i);
  contrib[i] = O::mul(__ldg(x2d + col), load_strip1(vals + i));
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

struct PhaseALaunch {
  const void* x2d;
  const int* lanesel;
  const void* vals;
  const int* blocksel;
  void* contrib;
  int64_t n_slots;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    if constexpr (!std::is_same<S, T>::value) {
      return cudaErrorInvalidValue;  // the stream holds the carrier type
    } else {
      const int64_t blocks = (n_slots + kThreads - 1) / kThreads;
      if (blocks > INT_MAX) return cudaErrorInvalidValue;
      sell_phase_a_kernel<SR, S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(x2d), lanesel, static_cast<const S*>(vals), blocksel,
          static_cast<T*>(contrib), n_slots);
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

// Phase A over every slab's stream: contrib (the first n_sublanes rows of
// the work buffer) = mul(x2d[blocksel, lanesel], vals). x2d is the padded
// (xrows, 128) x, lanesel the int32 (n_sublanes, 128) lanes, vals the
// (n_sublanes, 128) values and blocksel the int32 (n_sublanes,) blocks, in
// the carrier type (float32, or int32 for the int semirings and the or_and
// carrier: strip_dtype says which). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise.
int sh_sell_phase_a(int device, const void* x2d, const void* lanesel, const void* vals,
                    const void* blocksel, void* contrib, long long n_sublanes,
                    int semiring, int strip_dtype, void* stream) {
  if (n_sublanes < 0) return cudaErrorInvalidValue;
  if (n_sublanes == 0) return cudaSuccess;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const PhaseALaunch launch{x2d, static_cast<const int*>(lanesel), vals,
                            static_cast<const int*>(blocksel), contrib,
                            static_cast<int64_t>(n_sublanes) * kLanes,
                            static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// One level depth: entries [e0, e0 + n_entries) of the int32 launch table
// (kEntryWords per entry), n_rows output rows in all, one block each. idx
// is every (slab, level) idx array concatenated, work the (rows, 128) work
// buffer (contrib stream, then non-final level outputs), dp the (n_pad /
// 128, 128) result; both in the carrier type. Launches on `stream` and
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
