// Diagonal-layout (dia) semiring SpMV dp, for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for this layout: XLA lowers its
// sparseharness_tpu/ops/dia.py:dp_dia, D shifted slices of a padded x,
// into vector code. This kernel is the port's own route for stencils.
//
// What it computes, for every row i < n_rows of the (D, stride) values,
// vals[j, i] = A[i, i + off_j]:
//   dp[i] = ⊕_{j < D} mul(x̃[i + off_j], vals[j, i]),
//   x̃[c] = x[c] for 0 ≤ c < n_x, else 0̄.
// The bounds are checked here, so x is never padded or copied. Slots off the
// matrix hold 0̄ in vals (ops/dia.py:build_dia), so they meet 0̄ in x̃ as
// they do in ops/dia.py:dp_dia_plain, whose dp this is bit for bit under
// the six exact semirings (the float min and max are the IEEE minimum and
// maximum, semiring.cuh:Ieee, so the order of the ⊕ does not matter) and
// within rounding under plus_times.
//
// What bounds it: the values, read once (4 bytes a slot in f32, 2 in bf16).
// A thread owns a row and walks the D diagonals; for each, the 32 lanes of
// a warp read 32 neighbouring values (one 128-byte line, a streaming load
// so that the values do not evict x from L2) and 32 neighbouring x. A
// stencil's offsets come in runs of neighbours (HPCG's 27 in 9 runs of 3),
// so a run's x lines come from L1 after its first, and x, a few MB, stays
// in the 50 MB L2. The offsets are a kernel parameter, in the constant
// bank, read by every lane of a warp at once.
//
// Value types: f32 or bf16 (widened to f32 before ⊗) under the float
// semirings, int32 under min_right and max_right, bool under or_and (⊕ =
// max and ⊗ = min on {0, 1}, as the int32 carrier of the other kernels).
// x and the output are the semiring's own type (or_and's bool included),
// so no conversion runs around a launch.
//
// With `fold` set, each row's dp is ⊕-combined with 0̄ before it is stored:
// ops/torch_ops.py:fold_dp's clamp, which sends min_plus' +inf to FLT_MAX
// and max_times' negatives to 0, and the whole of an SpMV with no y, α or
// β (ops/registry.py:spmv). The call is then this one launch: the fold's
// two elementwise ops (4.7 µs of device time, and about 20 µs of the
// host's enqueue, at HPCG's 104³ grid) do not run.
//
// Back-to-back calls: the host enqueues a call in about 20 µs and the
// kernel takes about 42 at HPCG's 104³ grid, so the launch queue fills and
// the card sets the pace. Each launch is a programmatic dependent launch
// (wait_for_prior_launch): the next call's blocks are placed while this
// one's last wave runs, and the 1.2 µs gap between launches goes (43.3 →
// 42.3 µs a call on an H100, CUDA events over 4,000 calls).

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kMaxDiagonals = 512;  // as ops/dia.py:MAX_DIAGONALS

struct Offsets {
  int d;
  int off[kMaxDiagonals];
};

// one value in the compute type, with a streaming load
__device__ __forceinline__ float load_val(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) { return load_strip1(p); }
__device__ __forceinline__ int load_val(const int* p) { return __ldcs(p); }
__device__ __forceinline__ int load_val(const bool* p) {
  return __ldcs(reinterpret_cast<const unsigned char*>(p));
}

// one x entry in the compute type, through the read-only cache
__device__ __forceinline__ float load_x1(const float* p) { return __ldg(p); }
__device__ __forceinline__ int load_x1(const int* p) { return __ldg(p); }
__device__ __forceinline__ int load_x1(const bool* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(int* p, int v) { *p = v; }
__device__ __forceinline__ void store(bool* p, int v) { *p = v > 0; }

// Programmatic dependent launch (sm_90): a launch lets the next one be
// placed on the SMs as soon as each of its blocks runs, so back-to-back
// calls pay no launch gap, and each block of the next waits here until
// this launch has completed and its writes are visible (x may be its
// output). The pointers pass through the wait's asm, so the compiler
// cannot issue a load through them above it.
template <typename V, typename X>
__device__ __forceinline__ void wait_for_prior_launch(const V*& vals, const X*& x) {
  uint64_t v = reinterpret_cast<uint64_t>(vals), w = reinterpret_cast<uint64_t>(x);
  asm volatile("griddepcontrol.launch_dependents;\n\tgriddepcontrol.wait;"
               : "+l"(v), "+l"(w) : : "memory");
  vals = reinterpret_cast<const V*>(v);
  x = reinterpret_cast<const X*>(w);
}

template <int SR, typename V, typename X>
__global__ void __launch_bounds__(kThreads)
dia_dp_kernel(const V* vals, const X* x, X* __restrict__ out, int64_t n_rows, int64_t stride,
              int64_t n_x, int fold, const Offsets offs) {
  using B = Ieee<SR>;
  using T = typename B::T;
  wait_for_prior_launch(vals, x);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  const T zero = Op<SR>::zero();
  T acc = B::identity();
  // nine diagonals' loads issued together, a stencil's three runs of three
#pragma unroll 9
  for (int j = 0; j < offs.d; ++j) {
    const int64_t c = i + offs.off[j];
    const T xv = static_cast<uint64_t>(c) < static_cast<uint64_t>(n_x) ? load_x1(x + c) : zero;
    acc = B::add(acc, B::mul(xv, load_val(vals + j * stride + i)));
  }
  if (fold) acc = B::add(acc, zero);
  store(out + i, acc);
}

struct DiaLaunch {
  const void* vals;
  const void* x;
  void* out;
  int64_t n_rows, stride, n_x;
  int fold;
  const Offsets* offs;
  cudaStream_t stream;

  template <int SR, typename V, typename X>
  int run() const {
    cudaLaunchAttribute overlap[1];
    overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    overlap[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>((n_rows + kThreads - 1) / kThreads));
    config.blockDim = dim3(kThreads);
    config.stream = stream;
    config.attrs = overlap;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(&config, dia_dp_kernel<SR, V, X>, static_cast<const V*>(vals),
                              static_cast<const X*>(x), static_cast<X*>(out), n_rows, stride,
                              n_x, fold, *offs);
  }
};

// f32 or bf16 values under the float semirings, int32 under min_right and
// max_right, bool under or_and; cudaErrorInvalidValue for any other pair
template <int SR>
int dispatch_values(int val_dtype, const DiaLaunch& f) {
  if constexpr (std::is_same<typename Op<SR>::T, float>::value) {
    if (val_dtype == STRIP_F32) return f.run<SR, float, float>();
    if (val_dtype == STRIP_BF16) return f.run<SR, __nv_bfloat16, float>();
  } else if constexpr (SR == OR_AND) {
    if (val_dtype == STRIP_BOOL) return f.run<SR, bool, bool>();
  } else {
    if (val_dtype == STRIP_I32) return f.run<SR, int, int>();
  }
  return cudaErrorInvalidValue;
}

int dispatch_dia(int semiring, int val_dtype, const DiaLaunch& f) {
  switch (semiring) {
    case PLUS_TIMES: return dispatch_values<PLUS_TIMES>(val_dtype, f);
    case MIN_PLUS: return dispatch_values<MIN_PLUS>(val_dtype, f);
    case OR_AND: return dispatch_values<OR_AND>(val_dtype, f);
    case MAX_MIN: return dispatch_values<MAX_MIN>(val_dtype, f);
    case MAX_TIMES: return dispatch_values<MAX_TIMES>(val_dtype, f);
    case MAX_RIGHT: return dispatch_values<MAX_RIGHT>(val_dtype, f);
    case MIN_RIGHT: return dispatch_values<MIN_RIGHT>(val_dtype, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dp of the first n_rows rows: out[n_rows], in x's type (float32, int32, or
// bool under or_and). vals is the (d, stride) value array, stride ≥ n_rows;
// x holds n_x entries; offsets the d diagonal offsets (1 ≤ d ≤ 512); fold
// non-zero ⊕-combines each row with 0̄, as ops/torch_ops.py:fold_dp does.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// it does not synchronise.
int sh_dia_dp(int device, const void* vals, const void* x, void* out, long long n_rows,
              long long stride, long long n_x, const int* offsets, int d, int semiring,
              int val_dtype, int fold, void* stream) {
  if (d < 1 || d > kMaxDiagonals || n_rows < 0 || stride < n_rows || n_x < 0)
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  if ((n_rows + kThreads - 1) / kThreads > INT_MAX) return cudaErrorInvalidValue;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  Offsets offs;
  offs.d = d;
  for (int j = 0; j < d; ++j) offs.off[j] = offsets[j];
  const DiaLaunch launch{vals, x, out, n_rows, stride, n_x, fold, &offs,
                         static_cast<cudaStream_t>(stream)};
  rc = dispatch_dia(semiring, val_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
