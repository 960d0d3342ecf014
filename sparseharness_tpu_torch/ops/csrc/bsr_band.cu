// Banded semiring SpMV dp over bsr_band strips, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   STAGE_X = true   sparseharness_tpu/ops/pallas_bsr_band.py:dp_bsr_band
//                    (x resident: the block stages its x window in shared
//                    memory once);
//   STAGE_X = false  sparseharness_tpu/ops/pallas_bsr_band.py:_dp_windowed
//                    (x streamed: each warp reads x straight from global
//                    memory, through L1/L2, in chunks of kc window slots and
//                    ⊕-combines the chunk partials in registers).
//
// What it computes, for every padded row R of the (r_rows, bm, K·bn) strips:
//   g  = R / (gs·bm), gs = bn / bm           (the row's group)
//   w0 = clamp(g + c0, 0, c_blocks − K)      (the group's first x block)
//   dp[R] = ⊕_{e < K·bn} mul(x[w0·bn + e], strip[R, e])
// The window of slot k lane l is x[(w0 + k)·bn + l] = x[w0·bn + k·bn + l],
// so a group's whole window is the contiguous slice x[w0·bn, w0·bn + K·bn).
//
// What bounds it: the bytes of the strips read from device memory (one pass,
// 4 or 2 bytes per slot, 1-2 semiring ops per slot). x is K·bn ≤ 1024
// elements per group and is reused by the group's gs·bm rows. The design
// therefore makes one coalesced pass over the strips — a warp per row, 16
// bytes per lane per load, streaming loads (__ldcs) so that the strips do
// not evict x from L2 — and reads x from shared memory (staged) or L1/L2
// (streamed). One block per group: 4096 blocks at the bench width.
//
// Semirings, loads and bit-exactness: semiring.cuh.

#include "semiring.cuh"

namespace {

using namespace sh;

// One block per group of gs·bm = bn rows. Each warp takes rows
// warp, warp + 8, ...; its lanes cover 4 consecutive entries each (128 per
// warp load), ⊕-accumulate in a register, then ⊕-reduce across the warp.
// chunk = kc·bn entries per ⊕-partial (chunk = kbn when STAGE_X).
template <int SR, typename S, bool STAGE_X>
__global__ void __launch_bounds__(kThreads)
band_dp_kernel(const S* __restrict__ strips, const typename Op<SR>::T* __restrict__ x,
               typename Op<SR>::T* __restrict__ out, int rows_per_group, int kbn,
               int bn, int k, int chunk, int c0, int c_blocks) {
  using O = Op<SR>;
  using T = typename O::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);

  const int g = blockIdx.x;
  const int w0 = min(max(g + c0, 0), max(c_blocks - k, 0));
  const T* xwin = x + static_cast<int64_t>(w0) * bn;
  if (STAGE_X) {
    for (int i = threadIdx.x * 4; i < kbn; i += kThreads * 4) {
      T v[4];
      load_x4<false>(xwin + i, v);
      xs[i] = v[0]; xs[i + 1] = v[1]; xs[i + 2] = v[2]; xs[i + 3] = v[3];
    }
    __syncthreads();
  }
  const T* xsrc = STAGE_X ? xs : xwin;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(g) * rows_per_group;
  for (int r = warp; r < rows_per_group; r += kThreads / 32) {
    const S* srow = strips + (row0 + r) * kbn;
    T acc = O::identity();
    for (int c = 0; c < kbn; c += chunk) {
      T part = O::identity();
      for (int e = c + lane * 4; e < c + chunk; e += 128) {
        T a[4], xv[4];
        load_strip4(srow + e, a);
        load_x4<STAGE_X>(xsrc + e, xv);
        part = mul_add4<SR>(part, xv, a);
      }
      acc = O::add(acc, part);
    }
    acc = warp_reduce<SR>(acc);
    if (lane == 0) out[row0 + r] = acc;
  }
}

// the launch for one (semiring, strip type) instantiation, as dispatch
// calls it
struct BandLaunch {
  const void* strips;
  const void* x;
  void* out;
  int n_groups, rows_per_group, kbn, bn, k, chunk, c0, c_blocks;
  bool stage_x;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const S* s = static_cast<const S*>(strips);
    const T* xp = static_cast<const T*>(x);
    T* o = static_cast<T*>(out);
    if (stage_x) {
      const size_t smem = static_cast<size_t>(kbn) * sizeof(T);
      band_dp_kernel<SR, S, true><<<n_groups, kThreads, smem, stream>>>(
          s, xp, o, rows_per_group, kbn, bn, k, kbn, c0, c_blocks);
    } else {
      band_dp_kernel<SR, S, false><<<n_groups, kThreads, 0, stream>>>(
          s, xp, o, rows_per_group, kbn, bn, k, chunk, c0, c_blocks);
    }
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// dp over the padded rows: out[r_rows·bm] (float32, or int32 for the int
// semirings and the or_and carrier). x is the padded (c_blocks, bn) window
// source in the same type. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
int sh_band_dp(int device, const void* strips, const void* x, void* out,
               int r_rows, int bm, int kbn, int k, int kc, int c0,
               int c_blocks, int semiring, int strip_dtype, int stage_x,
               void* stream) {
  if (bm <= 0 || k <= 0 || kc <= 0 || kbn % k != 0 || k % kc != 0)
    return cudaErrorInvalidValue;
  const int bn = kbn / k;
  if (bn % bm != 0 || bn % 4 != 0 || c_blocks < k) return cudaErrorInvalidValue;
  const int gs = bn / bm;
  if (r_rows % gs != 0) return cudaErrorInvalidValue;
  const int n_groups = r_rows / gs;
  if (n_groups == 0) return cudaSuccess;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const BandLaunch launch{strips, x, out, n_groups, gs * bm, kbn, bn, k,
                          kc * bn, c0, c_blocks, stage_x != 0,
                          static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
