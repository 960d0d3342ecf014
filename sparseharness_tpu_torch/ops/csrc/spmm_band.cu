// Band SpMM Y = A·X over bsr_band strips (plus_times), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   sparseharness_tpu/ops/pallas_bsr_band.py:spmm_band (kernel body :334-352).
//
// What it computes: group g of the (r_rows, bm, K·bn) strips is a dense
// (gs·bm, K·bn) matrix A_g (gs = bn / bm block-rows, contiguous), and its X
// window is the K·bn contiguous rows of X (c_blocks·bn, m) that start at
//   w0 = clamp(g + c0, 0, c_blocks − K) · bn,
// as in bsr_band.cu. Then Y[g·gs·bm + i, c] = Σ_e A_g[i, e] · X[w0 + e, c],
// accumulated in float32 with plain FP32 FMAs: bf16 strips are upcast, and no
// tensor core (no TF32) touches an f32 product, as the JAX kernel forces
// Precision.HIGHEST for f32 strips.
//
// What bounds it: 2 operations per stored slot per column (51.5 Gop at the
// bench band and m = 128) against 1.3 GB of strips, X and Y, so the FP32
// units, not the memory, at m ≳ 32. This first kernel is a plain shared-
// memory tiled product: one block per (group, column tile of kBN columns),
// the group's rows and the window streamed through shared memory kBK
// entries at a time (A transposed, X as is), each thread a kTM × kTN tile of
// accumulators fed by float4 reads of shared memory. Every output is one
// thread's sequential sum over e, with no atomics, so the same call gives
// the same bits twice. Tensor cores (wgmma for bf16 strips, 3×TF32 for
// f32), TMA and double buffering are left to a later version.

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kBM = 128;  // output rows per block (a group at bn = 128)
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // window entries per staged chunk
constexpr int kTM = 8;    // rows per thread: 16 row groups of 8
constexpr int kTN = 4;    // columns per thread: 16 column groups of 4

// eight consecutive strip entries in float32, streaming loads; 32-byte (f32)
// or 16-byte (bf16) aligned
__device__ __forceinline__ void load_strip8(const float* p, float (&v)[8]) {
  float a[4], b[4];
  load_strip4(p, a);
  load_strip4(p + 4, b);
#pragma unroll
  for (int q = 0; q < 4; ++q) { v[q] = a[q]; v[q + 4] = b[q]; }
}

__device__ __forceinline__ void load_strip8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // little endian: the lower half comes first
    v[2 * q] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[q] & 0xffffu)));
    v[2 * q + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[q] >> 16)));
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
spmm_band_kernel(const S* __restrict__ strips, const float* __restrict__ x,
                 float* __restrict__ out, int rows_per_group, int row_tiles, int kbn,
                 int bn, int k, int c0, int c_blocks, int m) {
  __shared__ __align__(16) float as[kBK][kBM];  // A chunk, transposed
  __shared__ __align__(16) float xs[kBK][kBN];  // X chunk

  const int g = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x % row_tiles) * kBM;  // first row within the group
  const int64_t grow0 = static_cast<int64_t>(g) * rows_per_group;
  const int col0 = blockIdx.y * kBN;
  const int w0 = min(max(g + c0, 0), max(c_blocks - k, 0));
  const int tx = threadIdx.x % 16;  // columns tx·4 .. tx·4 + 3
  const int ty = threadIdx.x / 16;  // rows ty·8 .. ty·8 + 7

  // A loader: thread t stages row t / 2 of the tile, chunk entries
  // (t % 2)·8 .. + 7
  const int la_row = threadIdx.x >> 1;
  const int la_e = (threadIdx.x & 1) * 8;
  const bool la_ok = row0 + la_row < rows_per_group;
  const S* a_src = strips + (grow0 + row0 + la_row) * kbn + la_e;
  // X loader: thread t stages chunk row t / 16, columns (t % 16)·4 .. + 3
  const int lx_e = threadIdx.x >> 4;
  const int lx_c = (threadIdx.x & 15) * 4;
  const float* x_src = x + (static_cast<int64_t>(w0) * bn + lx_e) * m;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int e0 = 0; e0 < kbn; e0 += kBK) {
    float a[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (la_ok) load_strip8(a_src + e0, a);
#pragma unroll
    for (int q = 0; q < 8; ++q) as[la_e + q][la_row] = a[q];
    const float* xr = x_src + static_cast<int64_t>(e0) * m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col0 + lx_c + q;
      xs[lx_e][lx_c + q] = c < m ? __ldg(xr + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kBK; ++e) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[e][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[e][ty * kTM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[e][tx * kTN]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= rows_per_group) continue;
    float* orow = out + (grow0 + row) * m;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c < m) orow[c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Y over the padded rows: out (r_rows·bm, m), row-major float32. x is X
// padded with zero rows to (c_blocks·bn, m), row-major float32, with
// c_blocks ≥ K. strip_dtype is float32 or bfloat16 (semiring.cuh:StripCode).
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// it does not synchronise.
int sh_spmm_band(int device, const void* strips, const void* x, void* out, int r_rows,
                 int bm, int kbn, int k, int c0, int c_blocks, int m, int strip_dtype,
                 void* stream) {
  if (bm <= 0 || k <= 0 || kbn % k != 0 || m < 0 || r_rows < 0) return cudaErrorInvalidValue;
  const int bn = kbn / k;
  if (bn % bm != 0 || bn % kBK != 0 || c_blocks < k) return cudaErrorInvalidValue;
  const int gs = bn / bm;
  if (r_rows % gs != 0) return cudaErrorInvalidValue;
  const int n_groups = r_rows / gs;
  const int rows_per_group = gs * bm;
  const int row_tiles = (rows_per_group + kBM - 1) / kBM;
  if (n_groups == 0 || m == 0) return cudaSuccess;
  if (static_cast<int64_t>(n_groups) * row_tiles > INT_MAX || (m + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(static_cast<unsigned>(n_groups * row_tiles),
                  static_cast<unsigned>((m + kBN - 1) / kBN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (strip_dtype == STRIP_F32) {
    spmm_band_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(strips), xp, o, rows_per_group, row_tiles, kbn, bn, k,
        c0, c_blocks, m);
  } else if (strip_dtype == STRIP_BF16) {
    spmm_band_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(strips), xp, o, rows_per_group, row_tiles, kbn,
        bn, k, c0, c_blocks, m);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
