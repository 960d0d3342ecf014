// Blocked semiring SpMV dp over ELL-of-tiles strips, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   GATHER = true   sparseharness_tpu/ops/pallas_bsr_fused.py:dp_bsr_fused
//                   (x block rows gathered in the kernel by the tiles'
//                   block-columns);
//   GATHER = false  sparseharness_tpu/ops/pallas_bsr_ell.py:dp_bsr_ell
//                   (x strips gathered before the kernel, one per
//                   block-row, read beside the tile strips).
//
// What it computes, for every padded row R of the (R_blocks, bm, K·bn)
// strips, with block-row b = R / bm, slot k = e / bn and lane l = e % bn:
//   GATHER:   dp[R] = ⊕_{e < K·bn} mul(x2d[cols[b·K + k], l], strip[R, e])
//   !GATHER:  dp[R] = ⊕_{e < K·bn} mul(xt[b, e],               strip[R, e])
// bsr_fused's (S, R_s, bm, K·bn) slabs and (S, R_s·K) cols are read flat,
// as one (S·R_s, bm, K·bn) array in one launch: the slabs exist only for
// the TPU's scalar-prefetch memory.
//
// What bounds it: the bytes of the strips (one pass, 4 or 2 bytes per slot,
// two semiring ops per slot). x is small (0.5 MB at the bench width) and
// stays in L2, where the GATHER path reads it; the !GATHER path also
// streams the x strips, K·bn elements per block-row. The design makes one
// coalesced pass over the strips: a warp per row, 16 bytes (f32) or 8 bytes
// (bf16) per lane per load, streaming loads (__ldcs) so that the strips do
// not evict x from L2. The bm warps of a block-row read the same x slice,
// so it comes from L1 after the first.
//
// Semirings, loads and bit-exactness: semiring.cuh.

#include "semiring.cuh"

namespace {

using namespace sh;

template <int SR, typename S, bool GATHER>
__global__ void __launch_bounds__(kThreads)
strip_dp_kernel(const S* __restrict__ strips, const typename Op<SR>::T* __restrict__ x,
                const int* __restrict__ cols, typename Op<SR>::T* __restrict__ out,
                int64_t n_rows, int bm, int kbn, int bn, int k) {
  using T = typename Op<SR>::T;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int64_t b = row / bm;
  const S* srow = strips + row * kbn;
  T acc = Op<SR>::identity();
#pragma unroll 4
  for (int e = lane * 4; e < kbn; e += 128) {
    T a[4], xv[4];
    load_strip4(srow + e, a);
    if constexpr (GATHER) {
      const int slot = e / bn;
      const int64_t xb = __ldg(cols + b * k + slot);
      load_x4<false>(x + xb * bn + (e - slot * bn), xv);
    } else {
      load_x4<false>(x + b * kbn + e, xv);
    }
    acc = mul_add4<SR>(acc, xv, a);
  }
  acc = warp_reduce<SR>(acc);
  if (lane == 0) out[row] = acc;
}

struct StripLaunch {
  const void* strips;
  const void* x;
  const int* cols;
  void* out;
  int64_t n_rows;
  int bm, kbn, bn, k;
  bool gather;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const S* s = static_cast<const S*>(strips);
    const T* xp = static_cast<const T*>(x);
    T* o = static_cast<T*>(out);
    const unsigned blocks = static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
    if (gather) {
      strip_dp_kernel<SR, S, true><<<blocks, kThreads, 0, stream>>>(
          s, xp, cols, o, n_rows, bm, kbn, bn, k);
    } else {
      strip_dp_kernel<SR, S, false><<<blocks, kThreads, 0, stream>>>(
          s, xp, cols, o, n_rows, bm, kbn, bn, k);
    }
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// dp over the padded rows: out[r_blocks·bm] (float32, or int32 for the int
// semirings and the or_and carrier). With gather != 0, x is the padded
// (c_blocks, bn) vector and cols the int32 (r_blocks·K) block-columns; with
// gather == 0, x is the (r_blocks, K·bn) x strips and cols is unused.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success); it does not synchronise.
int sh_strip_dp(int device, const void* strips, const void* x, const void* cols,
                void* out, long long r_blocks, int bm, int kbn, int k,
                int semiring, int strip_dtype, int gather, void* stream) {
  if (bm <= 0 || k <= 0 || kbn % k != 0 || r_blocks < 0) return cudaErrorInvalidValue;
  const int bn = kbn / k;
  if (bn % 4 != 0 || (gather && cols == nullptr)) return cudaErrorInvalidValue;
  const int64_t n_rows = static_cast<int64_t>(r_blocks) * bm;
  if (n_rows == 0) return cudaSuccess;
  if ((n_rows + kWarps - 1) / kWarps > INT_MAX) return cudaErrorInvalidValue;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const StripLaunch launch{strips, x, static_cast<const int*>(cols), out, n_rows,
                           bm, kbn, bn, k, gather != 0,
                           static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
